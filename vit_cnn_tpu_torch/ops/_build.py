"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The kernels link into two shared libraries with a plain C interface,
loaded with :mod:`ctypes`: ``nvcc`` builds them in seconds, where a
source that includes PyTorch's headers takes minutes. ``kernels`` holds
every kernel that the serving and training paths launch; ``probes``
holds :data:`PROBE_SOURCES`, the variants that only the tuning sweeps
launch, whose many instances take longer to compile than the rest, so
that a serving or training process's first build does not wait on
them. Every ``.cu`` is compiled by its own ``nvcc`` process, those of
all the libraries being built started together, then each library is
linked. A library is keyed by a hash of its sources, the headers and the
flags, so an edit rebuilds; it lands in ``build/vit_cnn_tpu_torch/`` at
the root of the checkout, which the ``build/`` line of ``.gitignore``
already covers. Nothing is downloaded or prebuilt: a library's first
kernel launch in a process builds it.

Every C entry point returns ``cudaGetLastError()`` after its launches
(:func:`check` raises on a non-zero code), and takes pointers and the
CUDA stream as ``void*``. The backward kernels and train-mode
BatchNorm's reduce passes sum across blocks through a workspace (a
float32 tensor) that the wrapper allocates (:func:`workspace`) at the
size their ``*_workspace`` entry point reports.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "vit_cnn_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

#: the sources of the ``probes`` library (the tuning sweeps' V2, V3, V4)
PROBE_SOURCES = ("heads_variants.cu", "scan_variants.cu")
LIBRARIES = ("kernels", "probes")
#: the entry points of the ``probes`` library
_PROBE_ENTRIES = ("vct_selective_scan_batch_major", "vct_heads_attention_mma",
                  "vct_heads_attention_outer")

#: dtype codes of csrc/common.cuh ``vct::DType``
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches per wrapper, counted where each wrapper launches its
#: kernel (plain CPU calls do not count)
launches: collections.Counter = collections.Counter()

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_SIGNATURES = {
    "vct_selective_scan": [_I, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _P],
    "vct_selective_scan_tile": [_I] * 6,
    "vct_dir_conv_silu": [_I, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _P],
    "vct_inv_perm_weighted_sum": [_I, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _P],
    "vct_attention": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "vct_heads_attention": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _F,
                            _I, _I, _P],
    "vct_pooled_attention": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                             _I, _P],
    "vct_selective_scan_bwd": [_I] + [_P] * 14 + [_I] * 6 + [_P],
    "vct_dir_conv_silu_bwd": [_I] + [_P] * 11 + [_I] * 6 + [_P],
    "vct_inv_perm_weighted_sum_bwd": [_I] + [_P] * 11 + [_I] * 5 + [_P],
    "vct_selective_scan_tiled": [_I, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "vct_selective_scan_batch_major": [_I, _P, _P, _P, _P, _P, _P, _P,
                                       _I, _I, _I, _I, _P],
    "vct_heads_attention_mma": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
    "vct_heads_attention_outer": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                                  _P],
    "vct_bn_act": [_I, _P, _P, _L, _I, _P, _P, _P, _P, _P, _F, _I, _P],
    "vct_bn_train_moments": [_I, _P, _L, _I, _P, _P, _P],
    "vct_bn_train_apply": [_I, _P, _P, _L, _I, _P, _P, _P, _F, _I, _P, _P,
                           _F, _F, _P],
    "vct_bn_train_backward_sums": [_I, _P, _P, _L, _I, _P, _P, _P, _F, _I,
                                   _P, _P, _P, _P, _P],
    "vct_bn_train_backward_apply": [_I, _P, _P, _P, _L, _I, _P, _P, _P, _P,
                                    _F, _I, _P],
}
#: workspace sizes (float32 elements) of the entry points that sum across
#: blocks
_WORKSPACE_SIGNATURES = {
    "vct_selective_scan_bwd_workspace": [_I] * 5,
    "vct_dir_conv_silu_bwd_workspace": [_I] * 3,
    "vct_inv_perm_weighted_sum_bwd_workspace": [_I] * 4,
    "vct_bn_train_workspace": [_L, _I],
}

_lock = threading.Lock()
_libs: dict = {}
#: wall seconds of this process's build, by library (absent: loaded)
build_seconds: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the port's "
                       "CUDA kernels are built from csrc/ at first use")


def sources(library: str = "kernels", csrc: Path = CSRC) -> list:
    """The ``.cu`` files of one library in a ``csrc`` directory."""
    if library not in LIBRARIES:
        raise ValueError("no kernel library {!r}".format(library))
    return [src for src in sorted(Path(csrc).glob("*.cu"))
            if (src.name in PROBE_SOURCES) == (library == "probes")]


def library_path(library: str = "kernels") -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources(library) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / "libvct_{}_{}.so".format(library, h.hexdigest()[:16])


def compile_and_link(groups: dict, work_dir: Path) -> dict:
    """Build the shared library ``out`` of each ``{out: [sources]}`` entry:
    one ``nvcc`` per source, all started together, then one link per
    library. Returns each library's wall seconds from the common start
    to the end of its link; raises with nvcc's errors."""
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for out, srcs in groups.items():
        for src in srcs:
            obj = Path(work_dir) / "{}.{}.{}.o".format(src.stem, out.stem,
                                                       os.getpid())
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((out, obj, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
    failed, seconds = [], {}
    try:
        for _, _, cmd, proc in jobs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append("{}\n{}".format(" ".join(cmd), err[-4000:]))
        for out in groups:
            if failed:
                break
            tmp = out.with_suffix(".{}.tmp".format(os.getpid()))
            cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                   *(str(obj) for lib_, obj, _, _ in jobs if lib_ == out)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                failed.append("{}\n{}".format(" ".join(cmd),
                                              proc.stderr[-4000:]))
                break
            os.replace(tmp, out)       # atomic: concurrent builds agree
            seconds[out] = time.perf_counter() - t0
    finally:
        for _, obj, _, _ in jobs:
            obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return seconds


def build(*libraries: str) -> dict:
    """Compile the named libraries (by default ``kernels``) unless they
    exist, the sources of all of them together; their paths by name."""
    paths = {name: library_path(name) for name in libraries or ("kernels",)}
    todo = {name: path for name, path in paths.items() if not path.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        seconds = compile_and_link(
            {path: sources(name) for name, path in todo.items()}, BUILD_DIR)
        for name, path in todo.items():
            build_seconds[name] = seconds[path]
    return paths


def lib(library: str = "kernels") -> ctypes.CDLL:
    """A loaded kernel library, built on first use."""
    with _lock:
        if library not in _libs:
            handle = ctypes.CDLL(str(build(library)[library]))
            for table, restype in ((_SIGNATURES, ctypes.c_int),
                                   (_WORKSPACE_SIGNATURES, ctypes.c_longlong)):
                for name, args in table.items():
                    if (name in _PROBE_ENTRIES) != (library == "probes"):
                        continue
                    fn = getattr(handle, name)
                    fn.argtypes = args
                    fn.restype = restype
            _libs[library] = handle
    return _libs[library]


def check(name: str, code: int) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if code != 0:
        raise RuntimeError("{} failed: cudaError {}".format(name, code))


def workspace(name: str, *dims: int, device) -> torch.Tensor:
    """The float32 scratch a backward entry point sums its partials in."""
    floats = getattr(lib(), name + "_workspace")(*dims)
    return torch.empty(floats, dtype=torch.float32, device=device)


def use_plain(t: torch.Tensor) -> bool:
    """Dispatch by device: True for a CPU tensor (the plain version),
    False for a CUDA tensor (the kernel); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError("no kernel for device {}".format(t.device))


def wide(t: torch.Tensor) -> torch.dtype:
    """The dtype a plain version computes in for an input ``t``: float32,
    as the kernels do, or float64 for a float64 input (the CPU tests run
    the plain path in float64 against the JAX package in float64)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_inputs(*tensors: torch.Tensor) -> None:
    """Kernel-launch preconditions shared by every wrapper."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError("tensors on different devices: {} vs {}".format(
                dev, t.device))
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


def forward_only(what: str, *tensors: torch.Tensor) -> None:
    """Raise for an input that requires a gradient: the wrapper has no
    backward (its output would silently carry no ``grad_fn``)."""
    if any(t.requires_grad for t in tensors):
        raise ValueError("{} are forward only: an input requires a "
                         "gradient".format(what))


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError("kernels take float32 or bfloat16, got {}".format(
            t.dtype))
    return DTYPE_CODES[t.dtype]
