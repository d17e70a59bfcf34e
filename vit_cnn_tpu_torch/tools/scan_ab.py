"""An older commit's K1 beside this checkout's K1 and V1 at K1's plan.

  python -m vit_cnn_tpu_torch.tools.scan_ab OTHER.cu

``OTHER.cu`` is the ``csrc/selective_scan_fwd.cu`` of an older commit
(for example the parent's, unpacked with ``git archive``), with its
``common.cuh`` beside it. It and this checkout's
``csrc/selective_scan_fwd.cu`` (K1's kernel template, whose grid is V1)
are each built alone with the flags of ops/_build.py into a library of
their own. At the flagship's serving shapes, stage 1 (81, 72) and stage 2
(49, 128), 6 forward and 4 reverse streams, b = 7,588, in bf16 and
float32, three sides run on the same inputs: OTHER's
``vct_selective_scan`` (``other``), this checkout's (``this``), and this
checkout's ``vct_selective_scan_tiled`` at K1's plan (``plan``: rows = 4
x the C plan's R, chunk = K1's 4 steps). Per shape it prints, as one JSON
line, each side's CUDA-event medians from :data:`ROUNDS` rounds run in
the order other, this, plan, plan, this, other, the median of those, and
whether the three outputs are equal bit for bit. Then one summary line
with, where ``cuobjdump`` is beside ``nvcc``, whether each of OTHER's K1
instances (dtype x R x paired lanes) is the same SASS, instruction for
instruction, as this checkout's instance of the template at K1's 4
steps. So it shows whether K1 is still the older K1 after a change to
the template it shares with V1. Exit code 1 when an output differs.
"""

from __future__ import annotations

import ctypes
import json
import re
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
# a K1 instance's mangled template arguments: T, R, (steps,) kPair; an
# older file's kernel has no steps argument (its steps were 4)
_INSTANCE = re.compile(r"selective_scan_fwd_kernelI(13__nv_bfloat16|f)"
                       r"Li(\d+)E(?:Li(\d+)E)?Lb([01])E")
_DTYPE_TAGS = {"13__nv_bfloat16": "bfloat16", "f": "float32"}


def _library(src: Path, name: str, entries):
    """``src`` built alone into ``build/vit_cnn_tpu_torch/scan_ab_<name>
    .so`` with the port's nvcc flags: (its path, the library loaded with
    each of ``entries``' C signatures)."""
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
    for entry in entries:
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


def k1_instances(funcs) -> dict:
    """{"dtype R=r pair=p": instructions} of the template's instances at
    K1's 4 steps in ``funcs``."""
    out = {}
    for name, code in funcs.items():
        m = _INSTANCE.search(name)
        if m and int(m.group(3) or 4) == 4:
            out["{} R={} pair={}".format(_DTYPE_TAGS[m.group(1)], m.group(2),
                                         m.group(4))] = code
    return out


def sass_diff(theirs, ours, shown: int = 4) -> dict:
    """Whether two kernels' SASS is equal, their instruction counts, the
    number of differing positions and the first ``shown`` of them as
    (position, theirs, ours)."""
    diffs = [(i, a, b) for i, (a, b) in enumerate(zip(theirs, ours))
             if a != b]
    return dict(equal=theirs == ours, instructions=[len(theirs), len(ours)],
                differing=len(diffs), first=diffs[:shown])


def compare(other_lib, this_lib, label, ns, L, d, reverse, dtype) -> dict:
    """OTHER's K1, this checkout's K1 and V1 at K1's plan at one shape and
    dtype; see the module's docstring."""
    from ..ops import _build
    from ..ops.selective_scan import SCAN_CHUNK, SCAN_ROWS

    g = torch.Generator(device="cuda").manual_seed(0)
    u, dt, A, B, C, D = scan_inputs(g, ns, L, d, STATE, BAND, dtype)
    code = _build.dtype_code(u)
    rows = SCAN_ROWS * this_lib.vct_selective_scan_tile(code, ns, L, d,
                                                        STATE, BAND)
    stream = torch.cuda.current_stream().cuda_stream
    outs = {}

    def run(side):
        y = outs.setdefault(side, torch.empty_like(u))
        args = (code, u.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                C.data_ptr(), D.data_ptr(), y.data_ptr(), ns, L, d, STATE,
                BAND, int(reverse))
        if side == "other":
            err = other_lib.vct_selective_scan(*args, stream)
        elif side == "this":
            err = this_lib.vct_selective_scan(*args, stream)
        else:
            err = this_lib.vct_selective_scan_tiled(*args, rows, SCAN_CHUNK,
                                                    stream)
        _build.check("scan ({})".format(side), err)

    times = {"other": [], "this": [], "plan": []}
    for _ in range(ROUNDS):
        for side in ("other", "this", "plan", "plan", "this", "other"):
            times[side].append(median_ms(lambda: run(side)))
    torch.cuda.synchronize()
    return dict(case=label, streams=ns, L=L, d=d, b=BAND, reverse=reverse,
                dtype=str(dtype).split(".")[1], plan=[rows, SCAN_CHUNK],
                **{side + "_ms": statistics.median(t)
                   for side, t in times.items()},
                **{side + "_rounds": t for side, t in times.items()},
                bitwise_equal=torch.equal(outs["other"], outs["this"])
                and torch.equal(outs["this"], outs["plan"]))


def main() -> int:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__.splitlines()[2])
    if not torch.cuda.is_available():
        raise SystemExit("scan_ab: CUDA is not available")
    other_src = Path(sys.argv[1]).resolve()
    this_src = Path(__file__).resolve().parent.parent / "csrc" / \
        "selective_scan_fwd.cu"
    print(card_line(), flush=True)
    other_path, other_lib = _library(other_src, "other",
                                     ["vct_selective_scan"])
    this_path, this_lib = _library(
        this_src, "this", ["vct_selective_scan", "vct_selective_scan_tile",
                           "vct_selective_scan_tiled"])
    results = []
    for case in CASES:
        for dtype in DTYPES:
            results.append(compare(other_lib, this_lib, *case, dtype))
            print(json.dumps(results[-1]), flush=True)
            torch.cuda.empty_cache()
    sass = None
    other_funcs, this_funcs = _sass(other_path), _sass(this_path)
    if other_funcs is not None:
        theirs, ours = k1_instances(other_funcs), k1_instances(this_funcs)
        sass = {key: sass_diff(code, ours.get(key, []))
                for key, code in sorted(theirs.items())}
    ok = all(r["bitwise_equal"] for r in results)
    print(json.dumps({"other": str(other_src), "sass": sass,
                      "this_over_other": [r["this_ms"] / r["other_ms"]
                                          for r in results],
                      "plan_over_this": [r["plan_ms"] / r["this_ms"]
                                         for r in results], "ok": ok}),
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
