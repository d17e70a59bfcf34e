"""An older commit's K1 beside this checkout's V1 (8, 8), on the card.

  python -m vit_cnn_tpu_torch.tools.scan_ab OTHER.cu

``OTHER.cu`` is the ``csrc/selective_scan.cu`` of an older commit whose
K1 (``vct_selective_scan``) was the (8, 8) instance of V1's grid (for
example the parent's, unpacked with ``git archive``), with its
``common.cuh`` beside it. It and this checkout's ``csrc/selective_scan.cu``
(V1, the first K1 kept as a template) are each built with the flags of
ops/_build.py into a library of their own; OTHER's ``vct_selective_scan``
and this checkout's ``vct_selective_scan_tiled`` at (8, 8) run on the
same inputs at the flagship's serving shapes: stage 1 (81, 72) and stage
2 (49, 128), 6 forward and 4 reverse streams, b = 7,588, in bf16 and
float32. Per shape it prints, as one JSON line, each side's CUDA-event
medians from :data:`ROUNDS` rounds run in the order other, this, this,
other, the median of those, and whether the two outputs are equal bit for
bit. Then one summary line with, where ``cuobjdump`` is beside ``nvcc``,
whether each dtype's kernel is the same SASS instruction for instruction
(the (8, 8) instance of a templated kernel). So it shows whether V1 (8, 8),
the baseline the sweeps time beside the main path's K1, is still the
older K1. Exit code 1 when an output differs.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from . import card_line, median_ms, scan_inputs

ROUNDS = 3
STATE = 16
BAND = 7588
# (label, streams, L, d, reverse)
CASES = (("stage 1", 6, 81, 72, False), ("stage 1", 4, 81, 72, True),
         ("stage 2", 6, 49, 128, False), ("stage 2", 4, 49, 128, True))
DTYPES = (torch.bfloat16, torch.float32)
# mangled-name tags of the kernel's instances: the (8, 8) instance of a
# kernel templated on (T, rows, chunk), else the kernel templated on T alone
SASS_TAGS = {"bfloat16": "I13__nv_bfloat16", "float32": "If"}


def _library(src: Path, name: str, entry: str):
    """``src`` built alone into ``build/vit_cnn_tpu_torch/scan_ab_<name>
    .so`` with the port's nvcc flags: (its path, the library loaded with
    ``entry``'s C signature)."""
    from ..ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / "scan_ab_{}.so".format(name)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out),
           str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("{}\n{}".format(" ".join(cmd),
                                           proc.stderr[-4000:]))
    lib = ctypes.CDLL(str(out))
    fn = getattr(lib, entry)
    fn.argtypes = _build._SIGNATURES[entry]
    fn.restype = ctypes.c_int
    return out, lib


def _sass(path: Path):
    """{function name: [instruction, ...]} of a library's SASS, or None
    without ``cuobjdump``."""
    from ..ops import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        return None
    text = subprocess.run([str(tool), "-sass", str(path)],
                          capture_output=True, text=True, timeout=300).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            cur = funcs.setdefault(line.split(":", 1)[1].strip(), [])
        elif cur is not None and line.startswith("/*") and ";" in line:
            cur.append(line.split("*/", 1)[1].split(";", 1)[0].strip())
    return funcs


def _k1_sass(funcs, dtype_name):
    """The instructions of K1's kernel for one dtype in ``funcs``."""
    tag = "selective_scan_kernel" + SASS_TAGS[dtype_name]
    for suffix in ("Li8ELi8EE", "E"):
        found = [f for f in funcs if tag + suffix in f]
        if found:
            return funcs[found[0]]
    raise KeyError("no {} kernel for {}".format(tag, dtype_name))


def compare(other_lib, this_lib, label, ns, L, d, reverse, dtype) -> dict:
    """OTHER's K1 and this checkout's V1 (8, 8) at one shape and dtype;
    see the module's docstring."""
    from ..ops import _build

    g = torch.Generator(device="cuda").manual_seed(0)
    u, dt, A, B, C, D = scan_inputs(g, ns, L, d, STATE, BAND, dtype)
    stream = torch.cuda.current_stream().cuda_stream
    outs = {}

    def run(lib, side):
        y = outs.setdefault(side, torch.empty_like(u))
        args = (_build.dtype_code(u), u.data_ptr(), dt.data_ptr(),
                A.data_ptr(), B.data_ptr(), C.data_ptr(), D.data_ptr(),
                y.data_ptr(), ns, L, d, STATE, BAND, int(reverse))
        if side == "other":
            code = lib.vct_selective_scan(*args, stream)
        else:
            code = lib.vct_selective_scan_tiled(*args, 8, 8, stream)
        _build.check("scan ({})".format(side), code)

    sides = {"other": other_lib, "this": this_lib}
    times = {"other": [], "this": []}
    for _ in range(ROUNDS):
        for side in ("other", "this", "this", "other"):
            times[side].append(median_ms(lambda: run(sides[side], side)))
    torch.cuda.synchronize()
    return dict(case=label, streams=ns, L=L, d=d, b=BAND, reverse=reverse,
                dtype=str(dtype).split(".")[1],
                other_ms=statistics.median(times["other"]),
                this_ms=statistics.median(times["this"]),
                other_rounds=times["other"], this_rounds=times["this"],
                bitwise_equal=torch.equal(outs["other"], outs["this"]))


def main() -> int:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__.splitlines()[2])
    if not torch.cuda.is_available():
        raise SystemExit("scan_ab: CUDA is not available")
    other_src = Path(sys.argv[1]).resolve()
    this_src = Path(__file__).resolve().parent.parent / "csrc" / \
        "selective_scan.cu"
    print(card_line(), flush=True)
    other_path, other_lib = _library(other_src, "other", "vct_selective_scan")
    this_path, this_lib = _library(this_src, "this",
                                   "vct_selective_scan_tiled")
    results = []
    for case in CASES:
        for dtype in DTYPES:
            results.append(compare(other_lib, this_lib, *case, dtype))
            print(json.dumps(results[-1]), flush=True)
            torch.cuda.empty_cache()
    sass = {}
    other_funcs, this_funcs = _sass(other_path), _sass(this_path)
    if other_funcs is not None:
        for dn in SASS_TAGS:
            a, b = _k1_sass(other_funcs, dn), _k1_sass(this_funcs, dn)
            sass[dn] = dict(equal=a == b, instructions=[len(a), len(b)])
    ok = all(r["bitwise_equal"] for r in results)
    print(json.dumps({"other": str(other_src), "sass": sass or None,
                      "this_over_other": [r["this_ms"] / r["other_ms"]
                                          for r in results], "ok": ok}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
