"""Sources of K1 or K2 built side by side and timed on the card.

  python -m vit_cnn_tpu_torch.tools.kernel_ablation scan A.cu [B.cu ...]
  python -m vit_cnn_tpu_torch.tools.kernel_ablation conv A.cu [B.cu ...]

Each source is a copy of ``csrc/selective_scan_fwd.cu`` (``scan``, K1) or
``csrc/dirstream.cu`` (``conv``, K2) with ``common.cuh`` beside it: a
variant under study, or another commit's file unpacked with ``git
archive``. Each is built alone with the port's nvcc flags and ``-Xptxas
-v``, and the registers, spill bytes and static shared memory of its
kernels are printed as one JSON line. Then each source's entry point
(``vct_selective_scan`` or ``vct_dir_conv_silu``, the main path's C
signatures) runs on the same inputs at the flagship's shapes
(:data:`SCAN_CASES`, :data:`CONV_CASES`) in bf16 and float32: per shape
and dtype one JSON line with each source's max|diff| against the plain
version, whether it is within ``tools.TOL``, and the median of
:data:`ROUNDS` CUDA-event medians taken in rotating order (the sources in
order, then reversed). Exit code 1 when a source disagrees with the plain
version.
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

from . import card_line, compare, median_ms, scan_inputs

ROUNDS = 4
BAND, TRAIN = 7588, 1024
# (label, streams, L, d, b, reverse)
SCAN_CASES = (("stage 1", 6, 81, 72, BAND, False),
              ("stage 1", 4, 81, 72, BAND, True),
              ("stage 2", 6, 49, 128, BAND, False),
              ("train stage 1", 6, 81, 72, TRAIN, False),
              ("train stage 2", 4, 49, 128, TRAIN, True))
# (label, L, d, b): the '{L}_2+8' orders, 6 forward and 4 reverse streams
CONV_CASES = (("stage 1", 81, 72, BAND), ("stage 2", 49, 128, BAND),
              ("train stage 1", 81, 72, TRAIN))
DTYPES = (torch.bfloat16, torch.float32)
KINDS = {"scan": ("vct_selective_scan", "selective_scan_fwd_kernel"),
         "conv": ("vct_dir_conv_silu", "dir_conv_silu_kernel")}


def ptxas_usage(text: str, kernel: str) -> dict:
    """{mangled kernel name: registers, spill bytes, static shared memory}
    from ``-Xptxas -v`` output, for the functions whose name holds
    ``kernel``."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1) if kernel in m.group(1) else None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(cur, {}).update(spill_stores=int(m.group(1)),
                                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            out.setdefault(cur, {}).update(
                registers=int(m.group(1)),
                smem=int(smem.group(1)) if smem else 0)
    return out


def build(src: Path, index: int, kind: str):
    """``src`` built alone into ``build/vit_cnn_tpu_torch/ablation_<i>.so``:
    (the library with the entry point's C signature, ptxas usage)."""
    from ..ops import _build

    entry, kernel = KINDS[kind]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / "ablation_{}.so".format(index)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
           "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("{}\n{}".format(" ".join(cmd),
                                           proc.stderr[-4000:]))
    lib = ctypes.CDLL(str(out))
    fn = getattr(lib, entry)
    fn.argtypes = _build._SIGNATURES[entry]
    fn.restype = ctypes.c_int
    return fn, ptxas_usage(proc.stdout + proc.stderr, kernel)


def _timed(fns, names, want, dtype_name):
    """Each source's (max|diff|, ok, median ms) on one case."""
    rows = {}
    for name, fn in zip(names, fns):
        got = fn()
        err, ok = compare(got, want, dtype_name)
        rows[name] = dict(max_abs_err=err, ok=ok, rounds=[])
        del got
    for r in range(ROUNDS):
        order = list(zip(names, fns))
        for name, fn in (order if r % 2 == 0 else order[::-1]):
            rows[name]["rounds"].append(median_ms(fn))
    for row in rows.values():
        row["ms"] = statistics.median(row["rounds"])
    return rows


def scan_case(entries, names, label, ns, L, d, b, reverse, dtype):
    from ..ops import _build
    from ..ops.selective_scan import selective_scan_reference

    g = torch.Generator(device="cuda").manual_seed(0)
    u, dt, A, B, C, D = scan_inputs(g, ns, L, d, 16, b, dtype)
    want = selective_scan_reference(u, dt, A, B, C, D, reverse)
    stream = torch.cuda.current_stream().cuda_stream

    def runner(entry):
        def run():
            y = torch.empty_like(u)
            _build.check("vct_selective_scan", entry(
                _build.dtype_code(u), u.data_ptr(), dt.data_ptr(),
                A.data_ptr(), B.data_ptr(), C.data_ptr(), D.data_ptr(),
                y.data_ptr(), ns, L, d, 16, b, int(reverse), stream))
            return y
        return run

    dn = str(dtype).split(".")[1]
    return dict(case=label, streams=ns, L=L, d=d, b=b, reverse=reverse,
                dtype=dn, sources=_timed([runner(e) for e in entries], names,
                                         want, dn))


def conv_case(entries, names, label, L, d, b, dtype):
    import numpy as np

    from ..ops import _build
    from ..ops.dirstream import dir_conv_silu_reference
    from ..ops.scan_paths import base_paths

    orders, bases, _, rev_dir = base_paths("{}_2+8".format(L), L)
    i32 = dict(dtype=torch.int32, device="cuda")
    order_t = torch.tensor(np.stack([orders[i] for i in bases]), **i32)
    rev_rows = torch.tensor([i for i, r in enumerate(rev_dir) if r >= 0],
                            **i32)
    nb, nr = order_t.shape[0], rev_rows.shape[0]
    g = torch.Generator(device="cuda").manual_seed(0)
    u = torch.randn((L, d, b), generator=g, device="cuda").to(dtype)
    cw = 0.5 * torch.randn((4, d), generator=g, device="cuda")
    cb = 0.1 * torch.randn((d,), generator=g, device="cuda")
    want = torch.cat(dir_conv_silu_reference(u, cw, cb, order_t, rev_rows))
    stream = torch.cuda.current_stream().cuda_stream

    def runner(entry):
        def run():
            out = torch.empty((nb + nr, L, d, b), dtype=dtype, device="cuda")
            _build.check("vct_dir_conv_silu", entry(
                _build.dtype_code(u), u.data_ptr(), cw.data_ptr(),
                cb.data_ptr(), order_t.data_ptr(), rev_rows.data_ptr(),
                out.data_ptr(), out[nb:].data_ptr(), L, d, b, nb, nr, 4,
                stream))
            return out
        return run

    dn = str(dtype).split(".")[1]
    return dict(case=label, L=L, d=d, b=b, dtype=dn,
                sources=_timed([runner(e) for e in entries], names, want, dn))


def main() -> int:
    if len(sys.argv) < 3 or sys.argv[1] not in KINDS:
        raise SystemExit(__doc__.splitlines()[2])
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ablation: CUDA is not available")
    kind, srcs = sys.argv[1], [Path(p).resolve() for p in sys.argv[2:]]
    print(card_line(), flush=True)
    names, entries = [], []
    for i, src in enumerate(srcs):
        fn, usage = build(src, i, kind)
        names.append(str(src))
        entries.append(fn)
        print(json.dumps({"source": str(src), "ptxas": usage}), flush=True)
    ok = True
    for dtype in DTYPES:
        cases = SCAN_CASES if kind == "scan" else CONV_CASES
        for case in cases:
            res = (scan_case if kind == "scan" else conv_case)(
                entries, names, *case, dtype)
            ok &= all(r["ok"] for r in res["sources"].values())
            print(json.dumps(res), flush=True)
            torch.cuda.empty_cache()
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
