"""Sources of K1-K7 and V2-V4 built side by side and timed on the card.

  python -m vit_cnn_tpu_torch.tools.kernel_ablation mma|scan_bm|outer|scan|conv|sum|attn|scan_bwd|conv_bwd|sum_bwd A.cu [B.cu ...]

Each source is a copy of ``csrc/selective_scan_fwd.cu`` (``scan``, K1),
``csrc/dirstream.cu`` (``conv``, K2; ``sum``, K3),
``csrc/attention.cu`` (``attn``, K4), ``csrc/selective_scan_bwd.cu``
(``scan_bwd``, K5), ``csrc/dirstream_bwd.cu`` (``conv_bwd``, K6;
``sum_bwd``, K7), ``csrc/scan_variants.cu`` (``scan_bm``, V2) or
``csrc/heads_variants.cu`` (``mma``, V3; ``outer``, V4) with
``common.cuh`` (and ``mma.cuh``, ``hopper.cuh``) beside it: a variant
under study, or another commit's file unpacked with ``git archive``.
Each is built alone with the port's nvcc flags and ``-Xptxas -v``, and
the registers, spill bytes and shared memory of its kernels are printed
as one JSON line. Then each source's entry point (``vct_selective_scan``,
``vct_dir_conv_silu``, ``vct_inv_perm_weighted_sum``, ``vct_attention``,
``vct_selective_scan_batch_major``, ``vct_heads_attention_mma``,
``vct_heads_attention_outer``, or a backward entry point with its
workspace: ``vct_selective_scan_bwd``, ``vct_dir_conv_silu_bwd``,
``vct_inv_perm_weighted_sum_bwd``; the port's C signatures) runs on the
same inputs at the flagship's shapes (:data:`SCAN_CASES`,
:data:`CONV_CASES`, :data:`SUM_CASES`, :data:`ATTN_CASES`,
:data:`SCAN_BWD_CASES`, :data:`CONV_BWD_CASES`, :data:`SUM_BWD_CASES`:
each kernel's launches on the main path, the adjoints' those of a train
step; V2 at the scan sweep's forward cases, :data:`SCAN_BM_CASES`; V3
and V4 at the attention sweep's shapes, :data:`OUTER_CASES`) in bf16
and float32 (V3: bf16, per head and head-masked): per shape and
dtype one JSON line with each source's max|diff| against the plain
version, whether it is within ``tools.TOL`` (K5's outputs, and the
summed gradients of K6 and K7, sums whose terms cancel, against ``atol +
rtol * max|want|``), the median of :data:`ROUNDS` CUDA-event medians
taken in rotating order (the sources in order, then reversed), and for
K3-K7 and V2-V4 the launch's bound (``tools.bound``: bytes, FLOPs, K4's,
K5's, K6's, V2's, V3's and V4's exps), for V2 the time of K1 on the
same sequences in its lane-major layout, and for K4, V3 and V4 the time
of ``scaled_dot_product_attention`` on the same inputs. Exit code 1 when
a source disagrees with the plain version.
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

from . import TOL, bound, card_line, compare, median_ms, scan_inputs
from . import scan_sweep

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
# (label, L, d, b): K3's launches, 6 forward and 4 reverse streams
SUM_CASES = (("stage 1", 81, 72, BAND), ("stage 2", 49, 128, BAND),
             ("train stage 1", 81, 72, TRAIN))
# (label, G, Lq, Lk, dh): K4's launches, the NonLocal blocks of hsi1 and
# hsi2 (scale 1.0)
ATTN_CASES = (("stage 1", BAND, 49, 9, 128), ("stage 2", BAND, 25, 4, 72),
              ("train stage 1", TRAIN, 49, 9, 128))
# (label, streams, L, d, b, reverse): K5's four launches per train step
SCAN_BWD_CASES = (("train stage 1", 6, 81, 72, TRAIN, False),
                  ("train stage 1", 4, 81, 72, TRAIN, True),
                  ("train stage 2", 6, 49, 128, TRAIN, False),
                  ("train stage 2", 4, 49, 128, TRAIN, True))
# (label, L, d, b): K6's and K7's launches per train step, one per stage,
# 6 forward and 4 reverse streams, k = 4
CONV_BWD_CASES = (("train stage 1", 81, 72, TRAIN),
                  ("train stage 2", 49, 128, TRAIN))
SUM_BWD_CASES = CONV_BWD_CASES
# (label, B, n, h, hd): V4 at tools/heads_attn_variants.py's shapes
OUTER_CASES = (("probe", 4096, 65, 16, 4),
               ("MHST pooled band", 7592, 65, 16, 4),
               ("ViT band n=65", 7592, 65, 4, 16),
               ("SpectralFormer band", 7620, 146, 4, 16))
# (label, streams, L, d, b): V2 at tools/scan_sweep.py's forward cases,
# the streams' sequences laid out (ns b, L, d)
SCAN_BM_CASES = tuple(case[:5] for case in scan_sweep.CASES if not case[5])
DTYPES = (torch.bfloat16, torch.float32)
KINDS = {"scan": ("vct_selective_scan", "selective_scan_fwd_kernel"),
         "conv": ("vct_dir_conv_silu", "dir_conv_silu_kernel"),
         "sum": ("vct_inv_perm_weighted_sum", "inv_perm_weighted_sum_kernel"),
         "attn": ("vct_attention", "attention"),
         "scan_bwd": ("vct_selective_scan_bwd", "selective_scan_bwd_kernel"),
         "conv_bwd": ("vct_dir_conv_silu_bwd", "dir_conv_silu_bwd_kernel"),
         "sum_bwd": ("vct_inv_perm_weighted_sum_bwd",
                     "inv_perm_weighted_sum_bwd_kernel"),
         "outer": ("vct_heads_attention_outer", "heads_outer_kernel"),
         "mma": ("vct_heads_attention_mma", "mma_kernel"),
         "scan_bm": ("vct_selective_scan_batch_major",
                     "scan_batch_major_kernel")}
# the kinds whose kernels take bf16 only
BF16_ONLY = ("mma",)


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


def parse_args(argv):
    """(kind, sources) from the command line; SystemExit with the usage
    line for anything else."""
    if len(argv) < 2 or argv[0] not in KINDS:
        raise SystemExit(__doc__.splitlines()[2])
    return argv[0], [Path(p).resolve() for p in argv[1:]]


def build(srcs, kind: str):
    """Each of ``srcs`` built alone into
    ``build/vit_cnn_tpu_torch/ablation_<i>.so``, one nvcc process each, all
    started together: per source (the entry point with its C signature,
    ptxas usage); a backward entry point comes with its ``*_workspace``
    function as a pair."""
    from ..ops import _build

    entry, kernel = KINDS[kind]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = []
    for index, src in enumerate(srcs):
        out = _build.BUILD_DIR / "ablation_{}.so".format(index)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-shared", "-o", str(out), str(src)]
        started.append((cmd, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    built = []
    for cmd, out, proc in started:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("{}\n{}".format(" ".join(cmd), stderr[-4000:]))
        lib = ctypes.CDLL(str(out))
        fn = getattr(lib, entry)
        fn.argtypes = _build._SIGNATURES[entry]
        fn.restype = ctypes.c_int
        usage = ptxas_usage(stdout + stderr, kernel)
        ws_name = entry + "_workspace"
        if ws_name in _build._WORKSPACE_SIGNATURES:
            ws = getattr(lib, ws_name)
            ws.argtypes = _build._WORKSPACE_SIGNATURES[ws_name]
            ws.restype = ctypes.c_longlong
            fn = (fn, ws)
        built.append((fn, usage))
    return built


def compare_summed(got, want, dtype_name: str):
    """(max|diff| over the outputs, each output finite and within atol +
    rtol * max|want| of that output) for K5's sums."""
    rtol, atol = TOL[dtype_name]
    worst, ok = 0.0, True
    for x, y in zip(got, want):
        x, y = x.float(), y.float()
        d = float((x - y).abs().max()) if x.numel() else 0.0
        top = float(y.abs().max()) if y.numel() else 0.0
        worst = max(worst, d)
        ok = ok and bool(torch.isfinite(x).all()) and d <= atol + rtol * top
    return worst, ok


def compare_grads(got, want, dtype_name: str, plain: int):
    """(max|diff|, ok) of an adjoint's outputs: the first ``plain`` held
    elementwise (``tools.compare``), the summed gradients after them as
    :func:`compare_summed` holds them."""
    worst, ok = compare_summed(got[plain:], want[plain:], dtype_name)
    for x, y in zip(got[:plain], want[:plain]):
        err, this_ok = compare(x, y, dtype_name)
        worst, ok = max(worst, err), ok and this_ok
    return worst, ok


def _timed(fns, names, want, dtype_name, check=compare):
    """Each source's (max|diff|, ok, median ms) on one case."""
    rows = {}
    for name, fn in zip(names, fns):
        got = fn()
        err, ok = check(got, want, dtype_name)
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


def scan_bwd_case(entries, names, label, ns, L, d, b, reverse, dtype):
    from ..ops import _build
    from ..ops.selective_scan import selective_scan_backward_reference

    g = torch.Generator(device="cuda").manual_seed(0)
    u, dt, A, B, C, D = scan_inputs(g, ns, L, d, 16, b, dtype)
    cot = torch.randn((ns, L, d, b), generator=g, device="cuda").to(dtype)
    want = selective_scan_backward_reference(u, dt, A, B, C, D, cot,
                                             reverse)
    stream = torch.cuda.current_stream().cuda_stream
    dn = str(dtype).split(".")[1]

    def runner(entry):
        fn, ws = entry
        out = [torch.empty_like(x) for x in (u, u, A, B, C, D)]
        work = torch.empty(ws(ns, L, d, 16, b), dtype=torch.float32,
                           device="cuda")

        def run():
            du, ddt, dA, dB, dC, dD = out
            _build.check("vct_selective_scan_bwd", fn(
                _build.dtype_code(u), u.data_ptr(), dt.data_ptr(),
                A.data_ptr(), B.data_ptr(), C.data_ptr(), D.data_ptr(),
                cot.data_ptr(), du.data_ptr(), ddt.data_ptr(), dB.data_ptr(),
                dC.data_ptr(), dA.data_ptr(), dD.data_ptr(), work.data_ptr(),
                ns, L, d, 16, b, int(reverse), stream))
            return du, ddt, dA, dB, dC, dD
        return run

    bound_ms, bound_by = bound([u, dt, A, B, C, D, cot, *want], dn,
                               exps=ns * L * d * 16 * b)
    rows = _timed([runner(e) for e in entries], names, want, dn,
                  check=compare_summed)
    return dict(case=label, streams=ns, L=L, d=d, b=b, reverse=reverse,
                dtype=dn, bound_ms=bound_ms, bound_by=bound_by, sources=rows)


def _tables(L):
    """The '{L}_2+8' orders of the flagship's Mamba layer on the card:
    (orders, inverse orders, reverse rows), int32."""
    import numpy as np

    from ..ops.scan_paths import base_paths, inverse_permutation

    orders, bases, _, rev_dir = base_paths("{}_2+8".format(L), L)
    i32 = dict(dtype=torch.int32, device="cuda")
    order_t = torch.tensor(np.stack([orders[i] for i in bases]), **i32)
    inv_t = torch.tensor(np.stack([inverse_permutation(orders[i])
                                   for i in bases]), **i32)
    rev_rows = torch.tensor([i for i, r in enumerate(rev_dir) if r >= 0],
                            **i32)
    return order_t, inv_t, rev_rows


def conv_case(entries, names, label, L, d, b, dtype):
    from ..ops import _build
    from ..ops.dirstream import dir_conv_silu_reference

    order_t, _, rev_rows = _tables(L)
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


def sum_case(entries, names, label, L, d, b, dtype):
    from ..ops import _build
    from ..ops.dirstream import inv_perm_weighted_sum_reference

    _, inv, rev_rows = _tables(L)
    nb, nr = inv.shape[0], rev_rows.shape[0]
    g = torch.Generator(device="cuda").manual_seed(0)
    yf = torch.randn((nb, L, d, b), generator=g, device="cuda").to(dtype)
    yr = torch.randn((nr, L, d, b), generator=g, device="cuda").to(dtype)
    w = torch.softmax(torch.randn((nb + nr,), generator=g, device="cuda"), 0)
    wf, wr = w[:nb].contiguous(), w[nb:].contiguous()
    want = inv_perm_weighted_sum_reference(yf, yr, wf, wr, inv, rev_rows)
    stream = torch.cuda.current_stream().cuda_stream

    def runner(entry):
        def run():
            out = torch.empty((L, d, b), dtype=dtype, device="cuda")
            _build.check("vct_inv_perm_weighted_sum", entry(
                _build.dtype_code(yf), yf.data_ptr(), yr.data_ptr(),
                wf.data_ptr(), wr.data_ptr(), inv.data_ptr(),
                rev_rows.data_ptr(), out.data_ptr(), L, d, b, nb, nr,
                stream))
            return out
        return run

    dn = str(dtype).split(".")[1]
    bound_ms, bound_by = bound([yf, yr, wf, wr, inv, rev_rows, want], dn,
                               flops=2 * (nb + nr) * L * d * b)
    return dict(case=label, L=L, d=d, b=b, dtype=dn, bound_ms=bound_ms,
                bound_by=bound_by,
                sources=_timed([runner(e) for e in entries], names, want, dn))


def conv_bwd_case(entries, names, label, L, d, b, dtype):
    from ..ops import _build
    from ..ops.dirstream import dir_conv_silu_backward_reference

    order_t, _, rev_rows = _tables(L)
    nb, nr = order_t.shape[0], rev_rows.shape[0]
    g = torch.Generator(device="cuda").manual_seed(0)
    u = torch.randn((L, d, b), generator=g, device="cuda").to(dtype)
    cw = 0.5 * torch.randn((4, d), generator=g, device="cuda")
    cb = 0.1 * torch.randn((d,), generator=g, device="cuda")
    gf = torch.randn((nb, L, d, b), generator=g, device="cuda").to(dtype)
    gr = torch.randn((nr, L, d, b), generator=g, device="cuda").to(dtype)
    want = dir_conv_silu_backward_reference(u, cw, cb, order_t, rev_rows,
                                            gf, gr)
    stream = torch.cuda.current_stream().cuda_stream
    dn = str(dtype).split(".")[1]

    def runner(entry):
        fn, ws = entry
        out = [torch.empty_like(x) for x in want]
        work = torch.empty(ws(d, b, 4), dtype=torch.float32, device="cuda")

        def run():
            du, dcw, dcb = out
            _build.check("vct_dir_conv_silu_bwd", fn(
                _build.dtype_code(u), u.data_ptr(), cw.data_ptr(),
                cb.data_ptr(), order_t.data_ptr(), rev_rows.data_ptr(),
                gf.data_ptr(), gr.data_ptr(), du.data_ptr(), dcw.data_ptr(),
                dcb.data_ptr(), work.data_ptr(), L, d, b, nb, nr, 4, stream))
            return du, dcw, dcb
        return run

    # one sigmoid exp per stream output
    bound_ms, bound_by = bound([u, cw, cb, order_t, rev_rows, gf, gr, *want],
                               dn, exps=(nb + nr) * L * d * b)
    rows = _timed([runner(e) for e in entries], names, want, dn,
                  check=lambda x, y, n: compare_grads(x, y, n, plain=1))
    return dict(case=label, L=L, d=d, b=b, dtype=dn, bound_ms=bound_ms,
                bound_by=bound_by, sources=rows)


def sum_bwd_case(entries, names, label, L, d, b, dtype):
    from ..ops import _build
    from ..ops.dirstream import inv_perm_weighted_sum_backward_reference

    _, inv, rev_rows = _tables(L)
    nb, nr = inv.shape[0], rev_rows.shape[0]
    g = torch.Generator(device="cuda").manual_seed(0)
    yf = torch.randn((nb, L, d, b), generator=g, device="cuda").to(dtype)
    yr = torch.randn((nr, L, d, b), generator=g, device="cuda").to(dtype)
    w = torch.softmax(torch.randn((nb + nr,), generator=g, device="cuda"), 0)
    wf, wr = w[:nb].contiguous(), w[nb:].contiguous()
    cot = torch.randn((L, d, b), generator=g, device="cuda").to(dtype)
    want = inv_perm_weighted_sum_backward_reference(yf, yr, wf, wr, inv,
                                                    rev_rows, cot)
    stream = torch.cuda.current_stream().cuda_stream
    dn = str(dtype).split(".")[1]

    def runner(entry):
        fn, ws = entry
        dyf, dyr = torch.empty_like(yf), torch.empty_like(yr)
        dw = torch.empty((nb + nr,), dtype=torch.float32, device="cuda")
        work = torch.empty(ws(d, b, nb, nr), dtype=torch.float32,
                           device="cuda")

        def run():
            _build.check("vct_inv_perm_weighted_sum_bwd", fn(
                _build.dtype_code(yf), cot.data_ptr(), yf.data_ptr(),
                yr.data_ptr(), wf.data_ptr(), wr.data_ptr(), inv.data_ptr(),
                rev_rows.data_ptr(), dyf.data_ptr(), dyr.data_ptr(),
                dw.data_ptr(), work.data_ptr(), L, d, b, nb, nr, stream))
            return dyf, dyr, dw[:nb], dw[nb:]
        return run

    bound_ms, bound_by = bound([yf, yr, wf, wr, inv, rev_rows, cot, *want],
                               dn, flops=2 * (nb + nr) * L * d * b)
    rows = _timed([runner(e) for e in entries], names, want, dn,
                  check=lambda x, y, n: compare_grads(x, y, n, plain=2))
    return dict(case=label, L=L, d=d, b=b, dtype=dn, bound_ms=bound_ms,
                bound_by=bound_by, sources=rows)


def attn_case(entries, names, label, G, lq, lk, dh, dtype):
    import torch.nn.functional as F

    from ..ops import _build
    from ..ops.attention import attention_reference

    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (0.3 * torch.randn((G, n, dh), generator=g, device="cuda")
               for n in (lq, lk, lk))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    want = attention_reference(q, k, v, 1.0)
    stream = torch.cuda.current_stream().cuda_stream

    def runner(entry):
        def run():
            o = torch.empty_like(q)
            _build.check("vct_attention", entry(
                _build.dtype_code(q), q.data_ptr(), k.data_ptr(),
                v.data_ptr(), o.data_ptr(), G, lq, lk, dh, 1.0, stream))
            return o
        return run

    dn = str(dtype).split(".")[1]
    bound_ms, bound_by = bound([q, k, v, want], dn, exps=G * lq * lk,
                               flops=4 * G * lq * lk * dh)
    rows = _timed([runner(e) for e in entries], names, want, dn)
    sdpa_ms = median_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, scale=1.0))
    return dict(case=label, G=G, Lq=lq, Lk=lk, dh=dh, dtype=dn,
                bound_ms=bound_ms, bound_by=bound_by, sdpa_ms=sdpa_ms,
                sources=rows)


def outer_case(entries, names, label, B, n, h, hd, dtype):
    import torch.nn.functional as F

    from ..ops import _build
    from ..ops.attention import attention_reference_heads

    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((B, n, h, hd), generator=g, device="cuda")
               .to(dtype) for _ in range(3))
    scale = hd ** -0.5
    want = attention_reference_heads(q, k, v, scale)
    stream = torch.cuda.current_stream().cuda_stream

    def runner(entry):
        def run():
            o = torch.empty_like(q)
            _build.check("vct_heads_attention_outer", entry(
                _build.dtype_code(q), q.data_ptr(), k.data_ptr(),
                v.data_ptr(), o.data_ptr(), B, n, h, hd, scale, stream))
            return o
        return run

    dn = str(dtype).split(".")[1]
    bound_ms, bound_by = bound([q, k, v, want], dn, exps=B * h * n * n,
                               flops=4 * B * h * n * n * hd)
    rows = _timed([runner(e) for e in entries], names, want, dn)
    heads_first = lambda t: t.transpose(1, 2)
    sdpa_ms = median_ms(lambda: F.scaled_dot_product_attention(
        heads_first(q), heads_first(k), heads_first(v), scale=scale))
    return dict(case=label, B=B, n=n, h=h, hd=hd, dtype=dn,
                bound_ms=bound_ms, bound_by=bound_by, sdpa_ms=sdpa_ms,
                sources=rows)


def scan_bm_case(entries, names, label, ns, L, d, b, dtype):
    from ..ops import _build
    from ..ops.scan_variants import selective_scan_batch_major_reference
    from ..ops.selective_scan import selective_scan

    g = torch.Generator(device="cuda").manual_seed(0)
    u, dt, A, B, C, D = scan_inputs(g, ns, L, d, 16, b, dtype)
    lane = (u, dt, A, B, C, D)
    bm = lambda x: x.permute(0, 3, 1, 2).contiguous().view(ns * b, L, -1)
    u, dt, B, C = bm(u), bm(dt), bm(B), bm(C)
    want = selective_scan_batch_major_reference(u, dt, A, B, C, D)
    stream = torch.cuda.current_stream().cuda_stream

    def runner(entry):
        def run():
            y = torch.empty_like(u)
            _build.check("vct_selective_scan_batch_major", entry(
                _build.dtype_code(u), u.data_ptr(), dt.data_ptr(),
                A.data_ptr(), B.data_ptr(), C.data_ptr(), D.data_ptr(),
                y.data_ptr(), L, d, 16, ns * b, stream))
            return y
        return run

    dn = str(dtype).split(".")[1]
    bound_ms, bound_by = bound([u, dt, A, B, C, D, want], dn,
                               exps=ns * b * L * d * 16)
    rows = _timed([runner(e) for e in entries], names, want, dn)
    k1_ms = median_ms(lambda: selective_scan(*lane))
    return dict(case=label, streams=ns, L=L, d=d, b=b, dtype=dn,
                bound_ms=bound_ms, bound_by=bound_by, k1_ms=k1_ms,
                sources=rows)


def mma_case(entries, names, label, B, n, h, hd, dtype):
    """V3 per head (``sources``) and head-masked (``masked``, where h * hd
    is a multiple of 16 up to 128) at one shape."""
    import torch.nn.functional as F

    from ..ops import _build
    from ..ops.attention import attention_reference_heads
    from ..ops.heads_variants import MASKED_MAX_C

    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((B, n, h, hd), generator=g, device="cuda")
               .to(dtype) for _ in range(3))
    scale = hd ** -0.5
    want = attention_reference_heads(q, k, v, scale)
    stream = torch.cuda.current_stream().cuda_stream

    def runner(entry, masked):
        def run():
            o = torch.empty_like(q)
            _build.check("vct_heads_attention_mma", entry(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B,
                n, h, hd, scale, int(masked), stream))
            return o
        return run

    dn = str(dtype).split(".")[1]
    bound_ms, bound_by = bound([q, k, v, want], dn, exps=B * h * n * n,
                               flops=4 * B * h * n * n * hd)
    out = dict(case=label, B=B, n=n, h=h, hd=hd, dtype=dn,
               bound_ms=bound_ms, bound_by=bound_by)
    out["sources"] = _timed([runner(e, False) for e in entries], names,
                            want, dn)
    if (h * hd) % 16 == 0 and h * hd <= MASKED_MAX_C:
        out["masked"] = _timed([runner(e, True) for e in entries], names,
                               want, dn)
    heads_first = lambda t: t.transpose(1, 2)
    out["sdpa_ms"] = median_ms(lambda: F.scaled_dot_product_attention(
        heads_first(q), heads_first(k), heads_first(v), scale=scale))
    return out


CASES = {"scan": (SCAN_CASES, scan_case), "conv": (CONV_CASES, conv_case),
         "sum": (SUM_CASES, sum_case), "attn": (ATTN_CASES, attn_case),
         "scan_bwd": (SCAN_BWD_CASES, scan_bwd_case),
         "conv_bwd": (CONV_BWD_CASES, conv_bwd_case),
         "sum_bwd": (SUM_BWD_CASES, sum_bwd_case),
         "outer": (OUTER_CASES, outer_case),
         "mma": (OUTER_CASES, mma_case),
         "scan_bm": (SCAN_BM_CASES, scan_bm_case)}


def main() -> int:
    kind, srcs = parse_args(sys.argv[1:])
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ablation: CUDA is not available")
    print(card_line(), flush=True)
    names, entries = [], []
    for src, (fn, usage) in zip(srcs, build(srcs, kind)):
        names.append(str(src))
        entries.append(fn)
        print(json.dumps({"source": str(src), "ptxas": usage}), flush=True)
    ok = True
    cases, run_case = CASES[kind]
    for dtype in (torch.bfloat16,) if kind in BF16_ONLY else DTYPES:
        for case in cases:
            res = run_case(entries, names, *case, dtype)
            ok &= all(r["ok"] for key in ("sources", "masked")
                      for r in res.get(key, {}).values())
            print(json.dumps(res), flush=True)
            torch.cuda.empty_cache()
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
