"""Build and load the port's CUDA kernels (``csrc/*.cu``).

All kernels link into ONE shared library with a plain C interface,
loaded with :mod:`ctypes`: ``nvcc`` builds it in seconds, where a source
that includes PyTorch's headers takes minutes. Every ``csrc/*.cu`` is
compiled by its own ``nvcc`` process, all started together, then linked.
The library is keyed by a hash of the sources and the flags, so an edit
rebuilds; it lands in ``build/vit_cnn_tpu_torch/`` at the root of the
checkout, which the ``build/`` line of ``.gitignore`` already covers.
Nothing is downloaded or prebuilt: the first kernel launch in a process
builds it.

Every C entry point returns ``cudaGetLastError()`` after its launches
(:func:`check` raises on a non-zero code), and takes pointers and the
CUDA stream as ``void*``. The backward kernels sum across blocks through
a float32 workspace that the wrapper allocates (:func:`workspace`) at the
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

#: dtype codes of csrc/common.cuh ``vct::DType``
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches per wrapper, counted where each wrapper launches its
#: kernel (plain CPU calls do not count)
launches: collections.Counter = collections.Counter()

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "vct_selective_scan": [_I, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _P],
    "vct_dir_conv_silu": [_I, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _I, _I, _I, _P],
    "vct_inv_perm_weighted_sum": [_I, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _P],
    "vct_attention": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "vct_selective_scan_bwd": [_I] + [_P] * 14 + [_I] * 6 + [_P],
    "vct_dir_conv_silu_bwd": [_I] + [_P] * 11 + [_I] * 6 + [_P],
    "vct_inv_perm_weighted_sum_bwd": [_I] + [_P] * 11 + [_I] * 5 + [_P],
}
#: workspace sizes (float32 elements) of the backward entry points
_WORKSPACE_SIGNATURES = {
    "vct_selective_scan_bwd_workspace": [_I] * 5,
    "vct_dir_conv_silu_bwd_workspace": [_I] * 3,
    "vct_inv_perm_weighted_sum_bwd_workspace": [_I] * 4,
}

_lock = threading.Lock()
_lib = None
build_seconds = None    # wall time of this process's build (None: loaded)


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


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / "libvct_kernels_{}.so".format(h.hexdigest()[:16])


def build() -> Path:
    """Compile csrc/*.cu unless the library for these sources exists."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = "{}.{}".format(out.stem, os.getpid())
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / "{}.{}.o".format(src.stem, tag)
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE,
                                            text=True)))
        objs.append(obj)
    failed = []
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append("{}\n{}".format(" ".join(cmd), err[-4000:]))
    tmp = out.with_suffix(".{}.tmp".format(os.getpid()))
    if not failed:
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *(str(o) for o in objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            failed.append("{}\n{}".format(" ".join(cmd), proc.stderr[-4000:]))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, out)           # atomic: concurrent builds agree
    build_seconds = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for table, restype in ((_SIGNATURES, ctypes.c_int),
                                   (_WORKSPACE_SIGNATURES, ctypes.c_longlong)):
                for name, args in table.items():
                    fn = getattr(handle, name)
                    fn.argtypes = args
                    fn.restype = restype
            _lib = handle
    return _lib


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


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError("kernels take float32 or bfloat16, got {}".format(
            t.dtype))
    return DTYPE_CODES[t.dtype]
