#!/usr/bin/env python3
"""Smoke run of the PyTorch port (vit_cnn_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero before
the result lines:

1. device  — the card (nvidia-smi name and power limit), torch and CUDA
   versions, and the build of the kernels from csrc/.
2. kernels — each hand-written kernel against its plain PyTorch version
   on the card, in float32 (tight) and bfloat16 (one bf16 step), with
   median times of kernel and plain version (CUDA events): the forwards
   (K1 selective scan, K2 dir_conv_silu, K3 inv_perm_weighted_sum, K4
   attention) at the flagship's serving shapes and one ragged batch (K1,
   K2 and K3 timed at both stages in bf16, K4 at both NonLocal shapes
   beside SDPA, each with its bound and share; K1 beside the first K1,
   V1's (8, 8) instance, with the ratio new / old), the
   adjoints (K5-K7) at its train shapes (batch 1024 and a ragged 1001;
   K5 timed in bf16 at all four of a train step's launches, K6 and K7 at
   both train stages, each printed with its bound and share), and the
   gradients of the four autograd Functions against autograd through
   their plain versions.
3. slice   — the port's ``--serve`` daemon on the Synthetic scene at
   Houston2013 size (349 x 1905, 144 + 1 bands, 15 classes) under the bf16
   policy, with seeded random weights loaded through convert.py: three
   requests, seconds and windows/s each, a finite (349, 1905, 15) map,
   and every forward kernel's launch count in that run.
4. crop    — a 12 x 64 crop of the scene served on the card (kernels,
   float32 and bf16) and on the CPU in float32 (plain versions).
5. train   — the port's training run (the CLI without ``--serve``) on the
   same scene from the same seeded weights: bf16 over float32 master
   weights, batch 1024, flip/rotate on, a few epochs of a few steps, then
   the full-scene map of the best weights and OA/AA/Kappa. Then steady
   steps on one fixed batch of 1024 centers (ms/step, patches/s, peak
   device memory). Every loss finite, the loss falling over the steady
   steps, all seven kernels launched (K5-K7 once per backward per use
   site), every parameter still float32.
6. train-crop — one float32 step on the card and one on the CPU (plain
   versions) from the same weights and 32 centers, flip off: loss, every
   gradient and the updated BatchNorm statistics compared; the card's
   bf16 loss within a bound of the float32 one.
7. zoo     — the transformer zoo's ``--serve`` path on the same scene, bf16,
   seeded weights through convert.py: MHST for three requests, then
   SpectralFormer, S2EFT and GLT_Net for one each; seconds and windows/s,
   a finite (349, 1905, 15) map, and the head-last attention kernels (K8,
   K9) launched exactly as often as the models' layers and bands say.
8. zoo-crop — each zoo model on a 12 x 64 crop on the card (float32 and
   bf16) and on the CPU in float32, held to phase 4's limits; for MHST
   the number of head selections that differ between card and CPU.
9. variants — run right after phase 2: the kernel-tuning sweeps
   (``tools/scan_sweep.py``, ``tools/heads_attn_variants.py``) at their
   shapes with fewer repetitions, plus a ragged batch and one token. K1's
   (channels per block, time chunk) grid (V1) and the batch-major scan
   (V2) beside K1 and K1 fed by permute copies; the tensor-core (V3,
   per-head and head-masked) and CUDA-core outer-product (V4) forms of
   head-last attention beside K8 and SDPA. Every variant against its
   plain version, V1's (8, 8) instance (the first K1) within the same
   tolerance of K1, and each variant kernel launched.

Phase 2 also holds K8 and K9 (float32 and bf16, at every zoo band shape,
a ragged batch, one token, 17 tokens, odd hd and the 512-token limit) and
times both dtypes beside their plain versions,
``scaled_dot_product_attention`` (K8 without the residual; K4 too) and,
for K9, the composition of the plain group LayerNorm with K8.

Then one JSON line with the kernel table (time, plain time, bound and what
bounds it, library time, launches per path: serve, train, serve_zoo and
sweep), and as the last line
``{"ok": true, "device": {...}}``.
"""

import functools
import io
import json
import os
import subprocess
import sys
import tempfile
import time

SCENE = {"VCT_SYN_H": "349", "VCT_SYN_W": "1905", "VCT_SYN_BANDS": "144",
         "VCT_SYN_CLASSES": "15"}
SEED = 0
BAND_WINDOWS = 4 * 1897       # windows per band at --infer_chunk 8192
RAGGED = 1001
TRAIN_BATCH = 1024
CROP_TOL = 1e-3               # max|diff| of the f32 crop map, relative
# train-crop, card f32 against CPU f32 (plain versions):
# - the whole step's gradients, per tensor: ||diff|| <= GRAD_TOL * ||cpu||
#   + GRAD_ATOL * (the model's largest gradient norm). The flagship's
#   gradients at batch 32 are ill-conditioned: the CPU against itself with
#   1 thread instead of 8 (only the summation order changes) moves some
#   small gradients by 2.6e-2 of their largest entry (measured on the
#   H100 host's CPU). The floor is for gradients that vanish
#   mathematically (biases ahead of a train-mode BatchNorm, phi's bias
#   under the softmax): float32 rounding noise of 1e-9..1e-7 on both sides.
# - the updated BatchNorm statistics (forward values): max|diff| <=
#   STAT_TOL * max|cpu|.
# - each Mamba backbone alone (no BatchNorm, no ReLU: well conditioned),
#   the kernels' path in place at full width: every gradient max|diff| <=
#   BACKBONE_TOL * max|cpu|.
GRAD_TOL, GRAD_ATOL = 5e-2, 1e-5
STAT_TOL = 1e-3
BACKBONE_TOL = 1e-3
BF16_LOSS_TOL = 0.05          # |bf16 loss - f32 loss| / f32 loss on the card
STEADY_STEPS = 20
FORWARD = ("selective_scan", "dir_conv_silu", "inv_perm_weighted_sum",
           "fused_attention")
ADJOINTS = ("selective_scan_backward", "dir_conv_silu_backward",
            "inv_perm_weighted_sum_backward")
# launches per train step: two Mamba layers, each with a forward and a
# reverse scan, one dir_conv and one inverse sum; two NonLocal blocks
PER_STEP = {"selective_scan": 4, "dir_conv_silu": 2,
            "inv_perm_weighted_sum": 2, "fused_attention": 2,
            "selective_scan_backward": 4, "dir_conv_silu_backward": 2,
            "inv_perm_weighted_sum_backward": 2}
HEADS = ("fused_attention_heads", "pooled_heads_attention")
ZOO = ("MHST", "SpectralFormer", "S2EFT", "GLT_Net")
MHST_REQUESTS = 3
# K8 / K9 launches per full-scene request at --infer_chunk 8192 on the
# 349 x 1905 scene: bands (4 origin rows each) x launches per band. MHST
# (patch 8): 86 bands x 5 ViT layers, 86 x 8 pooled blocks; SpectralFormer
# (patch 1): 88 x 5; S2EFT (patch 7): 86 x 5; GLT_Net (patch 8): 86 x
# (5 encoder + 5 decoder layers)
ZOO_LAUNCHES = {"MHST": (430, 688), "SpectralFormer": (440, 0),
                "S2EFT": (430, 0), "GLT_Net": (860, 0)}
# windows per band: 4 origin rows x (1905 - patch + 1)
ZOO_BANDS = {"MHST": 4 * 1898, "SpectralFormer": 4 * 1905,
             "S2EFT": 4 * 1899}
# phase 9: the sweep tools' variant kernels (rows 10-13 of the table);
# their cases at fewer repetitions, plus a ragged batch and one token
VARIANTS = ("selective_scan_tiled", "selective_scan_batch_major",
            "heads_attention_mma", "heads_attention_outer")
SWEEP_REPS, SWEEP_PLAIN_REPS = 3, 1
RAGGED_SCANS = (("ragged", 6, 81, 72, RAGGED, False),
                ("ragged", 4, 81, 72, RAGGED, True))
RAGGED_HEADS = (("ragged", RAGGED, 65, 16, 4), ("ragged", RAGGED, 65, 4, 16),
                ("one token", RAGGED, 1, 16, 4),
                ("one token", RAGGED, 1, 4, 16))


class Failed(Exception):
    pass


def _compare(name, got, want, dtype_name, summed=()):
    """max|diff| of the kernel's output against the plain version's, held
    elementwise to the dtype's limits (``tools.compare``: |d| <= atol +
    rtol * |want|); the outputs listed in ``summed`` to |d| <= atol + rtol
    * max|want|. Those are the adjoints' sums: dA, dD, dcw, dcb and dw add
    up ~10^5 float32 terms, and every K5 output is a sum over the state or
    the channels whose terms cancel, so an entry near zero keeps the
    rounding of its large terms (the two sides' exp and reduction order
    differ on the card). K6's du (at most 40 terms per entry) and K7's dy
    are held elementwise. A summed output's line reports max|diff| /
    max|want|."""
    import torch

    from vit_cnn_tpu_torch.tools import TOL, compare

    rtol, atol = TOL[dtype_name]
    outs_g = got if isinstance(got, (tuple, list)) else (got,)
    outs_w = want if isinstance(want, (tuple, list)) else (want,)
    worst, ok = 0.0, True
    for i, (g, w) in enumerate(zip(outs_g, outs_w)):
        if g.numel() == 0:
            continue
        if i in summed:
            g, w = g.float(), w.float()
            d, top = float((g - w).abs().max()), float(w.abs().max())
            this_ok = bool(torch.isfinite(g).all()) and d <= atol + rtol * top
            print("    output {}: max|diff| {:.3e} of max|want| {:.3e}"
                  .format(i, d, top), flush=True)
        else:
            d, this_ok = compare(g, w, dtype_name)
        worst, ok = max(worst, d), ok and this_ok
    print("  {:<44s} {:<8s} max|diff| {:.3e}  (rtol {:g}, atol {:g})  {}"
          .format(name, dtype_name, worst, rtol, atol,
                  "ok" if ok else "FAIL"), flush=True)
    if not ok:
        raise Failed("{} {} disagrees with its plain version".format(
            name, dtype_name))
    return worst


def _record(rows, key, err, dtype_name, ms=None, plain_ms=None,
            bound=None, **timed):
    """Keep a kernel's worst error per dtype, and at its timed shape its
    time, its plain version's, its bound (``_bound``) and any other timed
    field (library_ms, ...)."""
    row = rows.setdefault(key, {"max_abs_err": 0.0, "max_abs_err_bf16": 0.0,
                                "library_ms": None})
    field = "max_abs_err" if dtype_name == "float32" else "max_abs_err_bf16"
    row[field] = max(row[field], err)
    if ms is not None:
        row["ms"], row["plain_ms"] = ms, plain_ms
        row["bound_ms"], row["bound_by"] = bound
        row.update(timed)


def _timed(rows, key, shape, dtype_name, **fields):
    """Keep one timed shape and dtype of a kernel under its row's
    ``timed``."""
    _record(rows, key, 0.0, dtype_name)          # the row exists
    rows[key].setdefault("timed", {}).setdefault(shape, {})[dtype_name] = \
        fields


def phase_device():
    import torch

    from vit_cnn_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi failed: " + smi.stderr.strip()
    print("[device] {}".format(card), flush=True)
    print("[device] torch {} cuda {} {} x{}".format(
        torch.__version__, torch.version.cuda,
        torch.cuda.get_device_name(0), torch.cuda.device_count()),
        flush=True)
    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    print("[device] kernels {} in {:.1f} s ({})".format(
        "built" if _build.build_seconds is not None else "loaded",
        time.perf_counter() - t0, path.name), flush=True)
    return card


def _tables(L):
    import numpy as np
    import torch

    from vit_cnn_tpu_torch.ops.scan_paths import (base_paths,
                                                  inverse_permutation)

    orders, bases, fwd_dir, rev_dir = base_paths("{}_2+8".format(L), L)
    i32 = dict(dtype=torch.int32, device="cuda")
    order_t = torch.tensor(np.stack([orders[i] for i in bases]), **i32)
    inv_t = torch.tensor(np.stack([inverse_permutation(orders[i])
                                   for i in bases]), **i32)
    rev_t = torch.tensor([i for i, r in enumerate(rev_dir) if r >= 0], **i32)
    return order_t, inv_t, rev_t


def phase_kernels():
    """Each kernel against its plain version; returns the JSON rows."""
    import torch
    import torch.nn.functional as F

    from vit_cnn_tpu_torch.ops import (attention, dirstream, scan_variants,
                                       selective_scan)
    from vit_cnn_tpu_torch.tools import bound as _bound
    from vit_cnn_tpu_torch.tools import median_ms as _median_ms
    from vit_cnn_tpu_torch.tools import scan_inputs as _scan_inputs

    g = torch.Generator(device="cuda").manual_seed(SEED)
    stages = [(81, 72), (49, 128)]          # (L, d) of hsi1 and hsi2
    rows = {}

    record = functools.partial(_record, rows)

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        timed = dtype == torch.bfloat16     # the serving dtype
        for (L, d) in stages:
            for b in (BAND_WINDOWS, RAGGED):
                band = timed and b == BAND_WINDOWS    # timed, both stages
                main = band and L == 81               # the table's shape
                stage = "serving stage {} (L={}, d={}, b={})".format(
                    1 if L == 81 else 2, L, d, b)
                # K1: forward over the 6 base streams, reverse over the 4
                for ns, rev in ((6, False), (4, True)):
                    args = _scan_inputs(g, ns, L, d, 16, b, dtype)
                    got = selective_scan.selective_scan(*args, reverse=rev)
                    want = selective_scan.selective_scan_reference(
                        *args, reverse=rev)
                    err = _compare("K1 scan ns={} L={} d={} b={}{}".format(
                        ns, L, d, b, " rev" if rev else ""), got, want, dn)
                    t = p = bound = None
                    extra = {}
                    if band and not rev:
                        t = _median_ms(lambda: selective_scan.selective_scan(
                            *args, reverse=rev))
                        # the first K1, V1's (8, 8) instance
                        old = _median_ms(
                            lambda: scan_variants.selective_scan_tiled(
                                *args, reverse=rev, rows=8, chunk=8))
                        p = _median_ms(
                            lambda: selective_scan.selective_scan_reference(
                                *args, reverse=rev), reps=3)
                        # one exp(dt A) per state element and step
                        bound = _bound(list(args) + [got], dn,
                                       exps=ns * L * d * 16 * b)
                        print("    K1 {}: kernel {:.3f} ms, first K1 (V1 "
                              "8x8) {:.3f}, new / old {:.3f}, plain {:.3f}, "
                              "bound {:.3f} ({})".format(
                                  stage, t, old, t / old, p, *bound),
                              flush=True)
                        _timed(rows, "selective_scan", stage, dn, ms=t,
                               first_k1_ms=old, plain_ms=p,
                               bound_ms=bound[0], bound_by=bound[1])
                        extra = {"first_k1_ms": old}
                        if not main:
                            t = p = bound = None
                            extra = {}
                    record("selective_scan", err, dn, t, p, bound, **extra)
                    del args, got, want
                # K2 / K3 with the real '{L}_2+8' orders
                orders, inv, rev_rows = _tables(L)
                u = torch.randn((L, d, b), generator=g,
                                device="cuda").to(dtype)
                cw = 0.5 * torch.randn((4, d), generator=g, device="cuda")
                cb = 0.1 * torch.randn((d,), generator=g, device="cuda")
                got = dirstream.dir_conv_silu(u, cw, cb, orders, rev_rows)
                want = dirstream.dir_conv_silu_reference(u, cw, cb, orders,
                                                         rev_rows)
                err = _compare("K2 dir_conv_silu L={} d={} b={}".format(
                    L, d, b), got, want, dn)
                t = p = bound = None
                if band:
                    t = _median_ms(lambda: dirstream.dir_conv_silu(
                        u, cw, cb, orders, rev_rows))
                    p = _median_ms(lambda: dirstream.dir_conv_silu_reference(
                        u, cw, cb, orders, rev_rows), reps=3)
                    # one SiLU exp per output
                    bound = _bound([u, cw, cb, orders, rev_rows, *got], dn,
                                   exps=10 * L * d * b)
                    print("    K2 {}: kernel {:.3f} ms, plain {:.3f}, bound "
                          "{:.3f} ({})".format(stage, t, p, *bound),
                          flush=True)
                    _timed(rows, "dir_conv_silu", stage, dn, ms=t,
                           plain_ms=p, bound_ms=bound[0], bound_by=bound[1])
                    if not main:
                        t = p = bound = None
                record("dir_conv_silu", err, dn, t, p, bound)
                yf, yr = got
                wts = torch.softmax(torch.randn((10,), generator=g,
                                                device="cuda"), 0)
                wf, wr = wts[:6], wts[6:]
                got = dirstream.inv_perm_weighted_sum(yf, yr, wf, wr, inv,
                                                      rev_rows)
                want = dirstream.inv_perm_weighted_sum_reference(
                    yf, yr, wf, wr, inv, rev_rows)
                err = _compare("K3 inv_perm_weighted_sum L={} d={} b={}"
                               .format(L, d, b), got, want, dn)
                t = p = bound = None
                if band:
                    t = _median_ms(lambda: dirstream.inv_perm_weighted_sum(
                        yf, yr, wf, wr, inv, rev_rows))
                    p = _median_ms(
                        lambda: dirstream.inv_perm_weighted_sum_reference(
                            yf, yr, wf, wr, inv, rev_rows), reps=3)
                    bound = _bound([yf, yr, wf, wr, inv, rev_rows, got], dn,
                                   flops=2 * 10 * L * d * b)
                    print("    K3 {}: kernel {:.3f} ms, plain {:.3f}, bound "
                          "{:.3f} ({}), share {:.1%}".format(
                              stage, t, p, *bound, bound[0] / t), flush=True)
                    _timed(rows, "inv_perm_weighted_sum", stage, dn, ms=t,
                           plain_ms=p, bound_ms=bound[0], bound_by=bound[1])
                    if not main:
                        t = p = bound = None
                record("inv_perm_weighted_sum", err, dn, t, p, bound)
                del u, got, want, yf, yr
        # K4 at the NonLocal shapes of hsi1 and hsi2
        for (lq, lk, dh) in ((49, 9, 128), (25, 4, 72)):
            for G in (BAND_WINDOWS, RAGGED):
                q = torch.randn((G, lq, dh), generator=g, device="cuda")
                k = torch.randn((G, lk, dh), generator=g, device="cuda")
                v = torch.randn((G, lk, dh), generator=g, device="cuda")
                q, k, v = (0.3 * x for x in (q, k, v))
                q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
                got = attention.fused_attention(q, k, v, 1.0)
                want = attention.attention_reference(q, k, v, 1.0)
                err = _compare("K4 attention G={} {}x{} dh={}".format(
                    G, lq, lk, dh), got, want, dn)
                t = p = bound = None
                extra = {}
                if timed and G == BAND_WINDOWS:       # timed, both shapes
                    shape = "serving {}x{} dh={} (G={})".format(lq, lk, dh,
                                                                 G)
                    t = _median_ms(lambda: attention.fused_attention(
                        q, k, v, 1.0))
                    p = _median_ms(lambda: attention.attention_reference(
                        q, k, v, 1.0))
                    bound = _bound([q, k, v, got], dn, exps=G * lq * lk,
                                   flops=4 * G * lq * lk * dh)
                    extra["library_ms"] = _median_ms(
                        lambda: F.scaled_dot_product_attention(
                            q, k, v, scale=1.0))
                    print("    K4 {}: kernel {:.3f} ms, plain {:.3f}, SDPA "
                          "{:.3f}, bound {:.3f} ({}), share {:.1%}".format(
                              shape, t, p, extra["library_ms"], *bound,
                              bound[0] / t), flush=True)
                    _timed(rows, "fused_attention", shape, dn, ms=t,
                           plain_ms=p, bound_ms=bound[0], bound_by=bound[1],
                           **extra)
                    if lq != 49:                      # the table's shape
                        t = p = bound = None
                        extra = {}
                record("fused_attention", err, dn, t, p, bound, **extra)
    torch.cuda.synchronize()
    phase_heads_kernels(rows)
    return rows


def _heads_qkv(g, B, n, h, hd, dtype):
    """q, k, v as the ViT hands them to K8: (B, n, h, hd) views of one
    fused (B, n, 3 h hd) projection."""
    import torch

    qkv = torch.randn((B, n, 3 * h * hd), generator=g, device="cuda")
    return tuple(t.view(B, n, h, hd) for t in qkv.to(dtype).chunk(3, -1))


def phase_heads_kernels(rows):
    """K8 and K9 against their plain versions at every zoo band shape, a
    ragged batch, one token, 17 tokens (a last key tile that is mostly
    padding), odd hd (5) and the 512-token limit at C = 256 (in bf16 the
    heads split over blocks); timed in both dtypes at the ViT and
    SpectralFormer bands (K8) and MHST's pooled band (K9) beside the plain
    versions, SDPA and, for K9, the plain group LayerNorm followed by K8.
    The kernel table keeps the bf16 times (the serving dtype) and, under
    ``timed``, every timed shape and dtype."""
    import torch
    import torch.nn.functional as F

    from vit_cnn_tpu_torch.ops import attention
    from vit_cnn_tpu_torch.tools import bound as _bound
    from vit_cnn_tpu_torch.tools import median_ms as _median_ms

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    record = functools.partial(_record, rows)
    mhst_b, sf_b = ZOO_BANDS["MHST"], ZOO_BANDS["SpectralFormer"]
    bands = {mhst_b: "ViT band", sf_b: "SpectralFormer band"}
    # (B, n, h, hd); the residual on and off except at the two long bands
    k8_cases = [(mhst_b, 65, 4, 16), (sf_b, 146, 4, 16),
                (ZOO_BANDS["S2EFT"], 145, 4, 16), (RAGGED, 65, 4, 16),
                (RAGGED, 1, 4, 16), (RAGGED, 17, 4, 16), (7, 65, 4, 5),
                (2, 512, 8, 32)]
    k9_cases = [(mhst_b, 65, 16, 4), (RAGGED, 65, 16, 4), (RAGGED, 1, 16, 4),
                (RAGGED, 17, 16, 4), (7, 65, 4, 5), (2, 512, 1, 32)]
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for B, n, h, hd in k8_cases:
            for res in ((False,) if n in (145, 146) else (False, True)):
                q, k, v = _heads_qkv(g, B, n, h, hd, dtype)
                scale = hd ** -0.5
                got = attention.fused_attention_heads(q, k, v, scale, res)
                want = attention.attention_reference_heads(q, k, v, scale,
                                                           res)
                err = _compare("K8 heads attention B={} n={} {}x{}{}".format(
                    B, n, h, hd, " +q" if res else ""), got, want, dn)
                t = p = bnd = None
                extra = {}
                if not res and B in bands:
                    t = _median_ms(lambda: attention.fused_attention_heads(
                        q, k, v, scale))
                    p = _median_ms(
                        lambda: attention.attention_reference_heads(
                            q, k, v, scale), reps=3)
                    lib = _median_ms(lambda: F.scaled_dot_product_attention(
                        q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), scale=scale))
                    bnd = _bound([q, k, v, got], dn, exps=B * h * n * n,
                                 flops=4 * B * h * n * n * hd)
                    print("    {} n={} {}: kernel {:.3f} ms, plain {:.3f}, "
                          "sdpa {:.3f}, bound {:.3f} ({}); K8 {} / SDPA "
                          "{:.3f}".format(bands[B], n, dn, t, p, lib, *bnd,
                                          dn, t / lib), flush=True)
                    _timed(rows, "fused_attention_heads",
                           "{} (B={}, n={}, {}x{})".format(bands[B], B, n, h,
                                                           hd), dn,
                           ms=t, plain_ms=p, library_ms=lib,
                           bound_ms=bnd[0], bound_by=bnd[1])
                    extra = {"library_ms": lib}
                    if dtype != torch.bfloat16 or B != mhst_b:
                        t = p = bnd = None          # the row keeps bf16's
                        extra = {}
                record("fused_attention_heads", err, dn, t, p, bnd, **extra)
                del q, k, v, got, want
        for B, n, h, hd in k9_cases:
            c = h * hd
            q, k, v = (torch.randn((B, n, c), generator=g, device="cuda")
                       .to(dtype) for _ in range(3))
            lns = [((1 + 0.2 * torch.randn(hd, generator=g, device="cuda"))
                    .to(dtype), (0.1 * torch.randn(hd, generator=g,
                                                   device="cuda")).to(dtype))
                   for _ in range(3)]
            scale = hd ** -0.5
            got = attention.pooled_heads_attention_auto(q, k, v, *lns, h,
                                                        scale)
            # float32: against the plain version in float64 (K9 takes its
            # LN statistics in float64 there; in float32 the fast variance
            # of a group with a large mean cancels, the plain version's too)
            wide = (lambda x: x.double()) if dtype == torch.float32 else (
                lambda x: x)
            want = attention.pooled_attention_reference(
                wide(q), wide(k), wide(v),
                *[tuple(map(wide, ln)) for ln in lns], h, scale)
            err = _compare("K9 pooled attention B={} n={} {}x{}".format(
                B, n, h, hd), got, want, dn)
            t = p = bnd = None
            extra = {}
            if B == mhst_b:
                if dtype == torch.float32:
                    # the float32 plain version's own distance from float64
                    plain32 = attention.pooled_attention_reference(
                        q, k, v, *lns, h, scale)
                    spread = float((plain32.double() - want).abs().max())
                    print("    plain float32 vs float64: max|diff| {:.3e}"
                          .format(spread), flush=True)
                    _record(rows, "pooled_heads_attention", 0.0, dn)
                    rows["pooled_heads_attention"]["plain_f32_vs_f64"] = \
                        spread
                    del plain32
                t = _median_ms(lambda: attention.pooled_heads_attention_auto(
                    q, k, v, *lns, h, scale))
                p = _median_ms(lambda: attention.pooled_attention_reference(
                    q, k, v, *lns, h, scale), reps=3)

                def composition():
                    heads = lambda x, ln: attention.ln_groups_reference(
                        x, *ln, hd).view(B, n, h, hd)
                    return attention.fused_attention_heads(
                        heads(q, lns[0]), heads(k, lns[1]), heads(v, lns[2]),
                        scale, True)

                comp = _median_ms(composition)
                bnd = _bound([q, k, v, *[x for ln in lns for x in ln], got],
                             dn, exps=B * h * n * n,
                             flops=4 * B * h * n * n * hd)
                print("    MHST pooled band {}: kernel {:.3f} ms, plain "
                      "{:.3f}, group LN + K8 {:.3f}, bound {:.3f} ({})"
                      .format(dn, t, p, comp, *bnd), flush=True)
                _timed(rows, "pooled_heads_attention",
                       "MHST pooled band (B={}, n={}, {}x{})".format(
                           B, n, h, hd), dn, ms=t, plain_ms=p,
                       composition_ms=comp, bound_ms=bnd[0],
                       bound_by=bnd[1])
                extra = {"composition_ms": comp}
                if dtype != torch.bfloat16:
                    t = p = bnd = None
                    extra = {}
            record("pooled_heads_attention", err, dn, t, p, bnd, **extra)
            del q, k, v, got, want
    torch.cuda.synchronize()


def phase_adjoints(rows):
    """K5-K7 against autograd through the plain forwards at the train
    shapes, then every autograd Function's gradients against autograd
    through its plain version; adds to the JSON rows."""
    import torch

    from vit_cnn_tpu_torch.ops import attention, dirstream, selective_scan
    from vit_cnn_tpu_torch.tools import bound as _bound
    from vit_cnn_tpu_torch.tools import median_ms as _median_ms
    from vit_cnn_tpu_torch.tools import scan_inputs as _scan_inputs

    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    randn = lambda *shape: torch.randn(shape, generator=g, device="cuda")

    record = functools.partial(_record, rows)

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for (L, d) in ((81, 72), (49, 128)):
            for b in (TRAIN_BATCH, RAGGED):
                train = dtype == torch.bfloat16 and b == TRAIN_BATCH
                main = train and L == 81
                for ns, rev in ((6, False), (4, True)):
                    args = _scan_inputs(g, ns, L, d, 16, b, dtype)
                    cot = randn(ns, L, d, b).to(dtype)
                    got = selective_scan.selective_scan_backward(
                        *args, cot, reverse=rev)
                    want = selective_scan.selective_scan_backward_reference(
                        *args, cot, rev)
                    err = _compare("K5 scan bwd ns={} L={} d={} b={}{}".format(
                        ns, L, d, b, " rev" if rev else ""), got, want, dn,
                        summed=range(6))
                    t = p = bound = None
                    if train:
                        # each of the train step's four K5 launches
                        t = _median_ms(
                            lambda: selective_scan.selective_scan_backward(
                                *args, cot, reverse=rev))
                        bound = _bound(list(args) + [cot, *got], dn,
                                       exps=ns * L * d * 16 * b)
                        print("  K5 {} ns={} L={} d={} b={}: {:.3f} ms, "
                              "bound {:.3f} ms ({}), share {:.1%}".format(
                                  dn, ns, L, d, b, t, bound[0], bound[1],
                                  bound[0] / t), flush=True)
                    if main and not rev:
                        p = _median_ms(lambda: selective_scan.
                                       selective_scan_backward_reference(
                                           *args, cot, rev), reps=3)
                    else:
                        t = bound = None
                    record("selective_scan_backward", err, dn, t, p, bound)
                    del args, cot, got, want
                orders, inv, rev_rows = _tables(L)
                u = randn(L, d, b).to(dtype)
                cw, cb = 0.5 * randn(4, d), 0.1 * randn(d)
                gf, gr = randn(6, L, d, b).to(dtype), randn(4, L, d, b).to(
                    dtype)
                bwd = lambda: dirstream.dir_conv_silu_backward(
                    u, cw, cb, orders, rev_rows, gf, gr)
                plain = lambda: dirstream.dir_conv_silu_backward_reference(
                    u, cw, cb, orders, rev_rows, gf, gr)
                out = bwd()
                err = _compare("K6 dir_conv_silu bwd L={} d={} b={}".format(
                    L, d, b), out, plain(), dn, summed=(1, 2))
                stage = "train stage {} (L={}, d={}, b={})".format(
                    1 if L == 81 else 2, L, d, b)
                t = p = bound = None
                if train:                     # timed, both stages
                    t, p = _median_ms(bwd), _median_ms(plain, reps=3)
                    # one sigmoid exp per stream output
                    bound = _bound([u, cw, cb, orders, rev_rows, gf, gr,
                                    *out], dn, exps=10 * L * d * b)
                    print("    K6 {}: kernel {:.3f} ms, plain {:.3f}, bound "
                          "{:.3f} ({}), share {:.1%}".format(
                              stage, t, p, *bound, bound[0] / t), flush=True)
                    _timed(rows, "dir_conv_silu_backward", stage, dn, ms=t,
                           plain_ms=p, bound_ms=bound[0], bound_by=bound[1])
                    if not main:              # the table's shape
                        t = p = bound = None
                record("dir_conv_silu_backward", err, dn, t, p, bound)
                wts = torch.softmax(randn(10), 0)
                wf, wr = wts[:6], wts[6:]
                cot = randn(L, d, b).to(dtype)
                bwd = lambda: dirstream.inv_perm_weighted_sum_backward(
                    gf, gr, wf, wr, inv, rev_rows, cot)
                plain = lambda: dirstream.\
                    inv_perm_weighted_sum_backward_reference(
                        gf, gr, wf, wr, inv, rev_rows, cot)
                out = bwd()
                err = _compare("K7 inv_perm_weighted_sum bwd L={} d={} b={}"
                               .format(L, d, b), out, plain(), dn,
                               summed=(2, 3))
                t = p = bound = None
                if train:
                    t, p = _median_ms(bwd), _median_ms(plain, reps=3)
                    bound = _bound([gf, gr, wf, wr, inv, rev_rows, cot, *out],
                                   dn, flops=2 * 10 * L * d * b)
                    print("    K7 {}: kernel {:.3f} ms, plain {:.3f}, bound "
                          "{:.3f} ({}), share {:.1%}".format(
                              stage, t, p, *bound, bound[0] / t), flush=True)
                    _timed(rows, "inv_perm_weighted_sum_backward", stage, dn,
                           ms=t, plain_ms=p, bound_ms=bound[0],
                           bound_by=bound[1])
                    if not main:
                        t = p = bound = None
                record("inv_perm_weighted_sum_backward", err, dn, t, p,
                       bound)
                del u, gf, gr, cot, out

    # the autograd Functions (forward kernel, backward kernel or plain
    # formula) against autograd through the plain versions, float32
    def grads(fn, inputs, cot):
        leaves = [x.detach().requires_grad_() for x in inputs]
        out = fn(*leaves)
        outs = out if isinstance(out, tuple) else (out,)
        if any(o.grad_fn is None for o in outs):
            raise Failed("an autograd Function's output has no grad_fn")
        torch.autograd.backward(outs, cot)
        return [x.grad for x in leaves]

    f32 = torch.float32
    args = _scan_inputs(g, 6, 81, 72, 16, RAGGED, f32)
    cot = (randn(6, 81, 72, RAGGED),)
    _compare("K1/K5 Function grads", grads(
        lambda *a: selective_scan.selective_scan(*a), args, cot), grads(
        lambda *a: selective_scan.selective_scan_reference(*a), args, cot),
        "float32", summed=range(6))
    orders, inv, rev_rows = _tables(81)
    conv_in = (randn(81, 72, RAGGED), 0.5 * randn(4, 72), 0.1 * randn(72))
    cot = (randn(6, 81, 72, RAGGED), randn(4, 81, 72, RAGGED))
    _compare("K2/K6 Function grads", grads(
        lambda *a: dirstream.dir_conv_silu(*a, orders, rev_rows), conv_in,
        cot), grads(lambda *a: dirstream.dir_conv_silu_reference(
            *a, orders, rev_rows), conv_in, cot), "float32", summed=(1, 2))
    wts = torch.softmax(randn(10), 0)
    sum_in = cot + (wts[:6], wts[6:])
    cot = (randn(81, 72, RAGGED),)
    _compare("K3/K7 Function grads", grads(
        lambda *a: dirstream.inv_perm_weighted_sum(*a, inv, rev_rows),
        sum_in, cot), grads(
        lambda *a: dirstream.inv_perm_weighted_sum_reference(
            *a, inv, rev_rows), sum_in, cot), "float32", summed=(2, 3))
    att_in = tuple(0.3 * randn(RAGGED, n, 128) for n in (49, 9, 9))
    cot = (randn(RAGGED, 49, 128),)
    _compare("K4 Function grads", grads(
        lambda *a: attention.fused_attention(*a, 1.0), att_in, cot), grads(
        lambda *a: attention.attention_reference(*a, 1.0), att_in, cot),
        "float32")
    heads_in = _heads_qkv(g, RAGGED, 65, 4, 16, f32)
    cot = (randn(RAGGED, 65, 4, 16),)
    _compare("K8 Function grads", grads(
        lambda *a: attention.fused_attention_heads(*a, 0.25), heads_in, cot),
        grads(lambda *a: attention.attention_reference_heads(*a, 0.25),
              heads_in, cot), "float32")
    pooled_in = tuple(randn(RAGGED, 65, 64) for _ in range(3)) + tuple(
        x for _ in range(3) for x in (1 + 0.2 * randn(4), 0.1 * randn(4)))
    cot = (randn(RAGGED, 65, 64),)
    # the LN scales and biases sum over every token and head
    _compare("K9 Function grads", grads(
        lambda *a: attention.pooled_heads_attention(*a, 16, 0.5), pooled_in,
        cot), grads(lambda q, k, v, a, b, c, d, e, f:
                    attention.pooled_attention_reference(
                        q, k, v, (a, b), (c, d), (e, f), 16, 0.5), pooled_in,
                    cot), "float32", summed=range(3, 9))
    torch.cuda.synchronize()


def phase_variants(rows):
    """The two sweep tools' functions (tools/scan_sweep.py,
    tools/heads_attn_variants.py) at their cases with fewer repetitions,
    plus a ragged batch and one token: every variant against its plain
    version (``tools.TOL``, as every kernel here: V1, V2 and V4 in float32
    and bf16; V3 in bf16 only, held to bf16's limit since it rounds
    P to bf16 before P.V as the TPU probes' F and G do; V1's (8, 8)
    instance, the first K1, also within that tolerance of K1, forward and
    reverse), timed beside
    K1 or K8, the plain version and SDPA. Adds rows 10-13 to the JSON
    rows and returns the run's launches (the path ``sweep``)."""
    import torch

    from vit_cnn_tpu_torch.ops import _build
    from vit_cnn_tpu_torch.tools import (all_ok, heads_attn_variants,
                                         scan_sweep)

    _build.launches.clear()
    t0 = time.perf_counter()
    scans, heads = [], []
    for case in scan_sweep.CASES + RAGGED_SCANS:
        for dtype in scan_sweep.DTYPES:
            scans.append(scan_sweep.sweep(*case, dtype, reps=SWEEP_REPS,
                                          plain_reps=SWEEP_PLAIN_REPS))
            print("[variants] {}".format(json.dumps(scans[-1])), flush=True)
            torch.cuda.empty_cache()
    for shape in heads_attn_variants.SHAPES + RAGGED_HEADS:
        for dtype in heads_attn_variants.DTYPES:
            heads.append(heads_attn_variants.sweep(
                *shape, dtype, reps=SWEEP_REPS, plain_reps=SWEEP_PLAIN_REPS))
            print("[variants] {}".format(json.dumps(heads[-1])), flush=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()     # the float32 scans' GBs, unused after
    counts = dict(_build.launches)
    print("[variants] {}".format(json.dumps(scan_sweep.summary(scans))),
          flush=True)
    print("[variants] {}".format(json.dumps(
        heads_attn_variants.summary(heads))), flush=True)
    print("[variants] {:.1f} s, launches {}".format(
        time.perf_counter() - t0, json.dumps(counts)), flush=True)
    bad = [(r.get("case", r.get("shape")), r["dtype"], r.get("reverse"),
            [v["variant"] for v in r["variants"] if not v["ok"]])
           for r in scans + heads if not all_ok(r)]
    if bad:
        raise Failed("variants disagree with their plain versions (V1's "
                     "(8, 8) instance: or with K1): {}".format(bad))
    missing = [k for k in VARIANTS if counts.get(k, 0) <= 0]
    if missing:
        raise Failed("variant kernels never launched: {}".format(missing))

    record = functools.partial(_record, rows)
    for r in scans + heads:
        for v in r["variants"]:
            if v["kernel"] in VARIANTS:
                record(v["kernel"], v["max_abs_err"], r["dtype"])
    # timed row: the best instance at the main band shape in bf16 (the
    # flagship's stage 1 forward over 6 streams; MHST's pooled band)
    main_scan = next(r for r in scans if r["case"] == "serving stage 1"
                     and not r["reverse"] and r["dtype"] == "bfloat16")
    main_heads = next(r for r in heads if r["shape"] == "MHST pooled band"
                      and r["dtype"] == "bfloat16")
    for key, res in ((VARIANTS[0], main_scan), (VARIANTS[1], main_scan),
                     (VARIANTS[2], main_heads), (VARIANTS[3], main_heads)):
        best = min((v for v in res["variants"] if v["kernel"] == key),
                   key=lambda v: v["ms"])
        record(key, 0.0, "bfloat16", best["ms"], best["plain_ms"],
               (res["bound_ms"], res["bound_by"]), share=best["share"],
               best=best["variant"], library_ms=best.get("library_ms"))
    # V3 has no float32 path: its error is its bf16 one
    rows[VARIANTS[2]]["max_abs_err"] = rows[VARIANTS[2]]["max_abs_err_bf16"]
    return counts


def _seeded_state(name, n_bands, n_classes):
    """The seeded state_dict of a registered model (convert.py)."""
    from vit_cnn_tpu_torch.convert import seeded_state_dict
    from vit_cnn_tpu_torch.models.registry import get_model

    model = get_model(name, n_classes=n_classes, n_bands=n_bands)[0]
    return seeded_state_dict(model, SEED)


def phase_slice(tmp):
    import numpy as np

    from vit_cnn_tpu_torch.data import get_dataset
    from vit_cnn_tpu_torch.cli import build_parser, run_serve
    from vit_cnn_tpu_torch.ops import _build

    img1, img2, gt = get_dataset("Synthetic", tmp)[:3]
    h, w = img1.shape[:2]
    n_classes = int(SCENE["VCT_SYN_CLASSES"])
    windows = (h - 8) * (w - 8)
    print("[slice] scene {} x {} x {} + {}, {} windows".format(
        h, w, img1.shape[2], img2.shape[2], windows), flush=True)
    state = _seeded_state("Multimodality_Mamba",
                          (img1.shape[2], img2.shape[2]), n_classes)
    gt_path = os.path.join(tmp, "gt.npy")
    np.save(gt_path, gt)
    out, pred = os.path.join(tmp, "probs.npy"), os.path.join(tmp, "pred.npy")
    requests = [{}, {}, {"pred": pred, "out": out, "gt": gt_path},
                {"cmd": "quit"}]
    args = build_parser().parse_args([
        "--dataset", "Synthetic", "--folder", tmp, "--model",
        "Multimodality_Mamba", "--bf16", "--serve", "--seed", str(SEED)])
    in_s = io.StringIO("\n".join(json.dumps(r) for r in requests) + "\n")
    out_s = io.StringIO()
    _build.launches.clear()
    served = run_serve(args, in_stream=in_s, out_stream=out_s,
                       state_dict=state)
    counts = dict(_build.launches)
    resps = [json.loads(l) for l in out_s.getvalue().splitlines() if l]
    for r in resps:
        print("[slice] response {}".format(json.dumps(r)), flush=True)
        if r.get("ok"):
            print("[slice]   {:.3f} s/request, {:.0f} windows/s".format(
                r["seconds"], windows / r["seconds"]), flush=True)
    if served != 3 or len(resps) != 3 or not all(r["ok"] for r in resps):
        raise Failed("serving did not answer 3 requests ok")
    probs = np.load(out)
    finite = bool(np.isfinite(probs).all())
    print("[slice] map {} finite={} max|p|={:.4f}".format(
        probs.shape, finite, float(np.abs(probs).max())), flush=True)
    if probs.shape != (h, w, n_classes) or not finite:
        raise Failed("bad map")
    print("[slice] launches {}".format(json.dumps(counts)), flush=True)
    missing = [k for k in ("selective_scan", "dir_conv_silu",
                           "inv_perm_weighted_sum", "fused_attention")
               if counts.get(k, 0) <= 0]
    if missing:
        raise Failed("kernels never launched on the main path: {}".format(
            missing))
    return counts, resps, state


def phase_crop(tmp, state):
    import numpy as np
    import torch

    from vit_cnn_tpu_torch.data import get_dataset
    from vit_cnn_tpu_torch.infer.fullscene import full_scene_probabilities
    from vit_cnn_tpu_torch.models.registry import get_model

    img1, img2 = (x[:12, :64] for x in get_dataset("Synthetic", tmp)[:2])
    n_classes = int(SCENE["VCT_SYN_CLASSES"])

    def serve(device, bf16):
        model, _, hp = get_model("Multimodality_Mamba", n_classes=n_classes,
                                 n_bands=(img1.shape[2], img2.shape[2]))
        model.load_state_dict(state)
        model.to(device).eval()
        return full_scene_probabilities(model, img1, img2,
                                        dict(hp, bf16=bf16))

    cpu = serve("cpu", False)
    f32 = serve("cuda", False)
    b16 = serve("cuda", True)
    inner = (slice(4, 12 - 4), slice(4, 64 - 4))     # window centers
    scale = max(1.0, float(np.abs(cpu).max()))
    d32 = float(np.abs(f32 - cpu).max())
    d16 = float(np.abs(b16 - cpu).max())
    agree32 = float((f32[inner].argmax(-1) == cpu[inner].argmax(-1)).mean())
    agree16 = float((b16[inner].argmax(-1) == cpu[inner].argmax(-1)).mean())
    print("[crop] card f32 vs cpu f32: max|diff| {:.3e} (limit {:.1e}), "
          "argmax agreement {:.4f}".format(d32, CROP_TOL * scale, agree32),
          flush=True)
    print("[crop] card bf16 vs cpu f32: max|diff| {:.3e}, argmax agreement "
          "{:.4f} (limit 0.99) over {} windows".format(
              d16, agree16, cpu[inner].shape[0] * cpu[inner].shape[1]),
          flush=True)
    if d32 > CROP_TOL * scale or agree16 < 0.99:
        raise Failed("crop map disagrees with the CPU plain path")


def _check_counts(counts, steps, where):
    """Every kernel launched; the adjoints exactly once per backward per
    use site."""
    print("[{}] launches {}".format(where, json.dumps(counts)), flush=True)
    missing = [k for k in FORWARD + ADJOINTS if counts.get(k, 0) <= 0]
    if missing:
        raise Failed("kernels never launched in {}: {}".format(where,
                                                              missing))
    if steps is not None:
        off = {k: counts.get(k, 0) for k in ADJOINTS
               if counts.get(k, 0) != PER_STEP[k] * steps}
        if off:
            raise Failed("{}: {} steps but adjoint launches {}".format(
                where, steps, off))


def phase_train(tmp, state):
    """The CLI's training run at full width, then steady steps."""
    import numpy as np
    import torch

    from vit_cnn_tpu_torch.cli import build_parser, run_train
    from vit_cnn_tpu_torch.data import get_dataset
    from vit_cnn_tpu_torch.ops import _build
    from vit_cnn_tpu_torch.tools import flagship_step

    args = build_parser().parse_args([
        "--dataset", "Synthetic", "--folder", tmp, "--model",
        "Multimodality_Mamba", "--bf16", "--batch_size", str(TRAIN_BATCH),
        "--flip_augmentation", "--epoch", "3", "--training_sample", "200",
        "--log_every", "1", "--seed", str(SEED)])
    _build.launches.clear()
    t0 = time.perf_counter()
    result = run_train(args, state_dict=state)
    wall = time.perf_counter() - t0
    counts = dict(_build.launches)
    print("[train] run_train {:.1f} s: {} centers, epoch losses {}, val {}, "
          "OA {:.2f} AA {:.4f} Kappa {:.4f}".format(
              wall, result["train_samples"], result["losses"],
              result["val_accuracies"], result["OA"], result["AA"],
              result["Kappa"]), flush=True)
    if not all(np.isfinite(result["losses"])):
        raise Failed("non-finite epoch loss")
    steps_per_epoch = -(-result["train_samples"] // TRAIN_BATCH)
    _check_counts(counts, steps_per_epoch * result["epochs"], "train")

    # steady steps on one fixed batch (as bench.py's measure_train_ours)
    trainer, step_args = flagship_step(
        get_dataset("Synthetic", tmp)[:3], state, "cuda", TRAIN_BATCH,
        bf16=True, flip=True, seed=SEED)
    first = trainer._step(*step_args)                      # not timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.launches.clear()
    losses = []
    t0 = time.perf_counter()
    for _ in range(STEADY_STEPS):
        losses.append(trainer._step(*step_args))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts_steady = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(first)] + [float(x) for x in losses]
    ms = 1e3 * secs / STEADY_STEPS
    print("[train] steady: {} steps of {} in {:.3f} s: {:.2f} ms/step, "
          "{:.0f} patches/s, peak device memory {:.2f} GB".format(
              STEADY_STEPS, TRAIN_BATCH, secs, ms,
              STEADY_STEPS * TRAIN_BATCH / secs, peak / 1e9), flush=True)
    print("[train] steady losses {}".format(
        " ".join("{:.4f}".format(x) for x in losses)), flush=True)
    if not all(np.isfinite(losses)):
        raise Failed("non-finite loss in the steady steps")
    if not np.mean(losses[-3:]) < np.mean(losses[:3]):
        raise Failed("the loss did not fall over the steady steps")
    _check_counts(counts_steady, STEADY_STEPS, "train steady")
    off = [k for k, p in trainer.model.named_parameters()
           if p.dtype != torch.float32]
    if off:
        raise Failed("bf16 training changed parameter dtypes: {}".format(off))
    return counts, {"ms_per_step": ms,
                    "patches_per_s": STEADY_STEPS * TRAIN_BATCH / secs,
                    "peak_gb": peak / 1e9}


def phase_train_crop(tmp, state):
    """One float32 step on the card and on the CPU from the same weights
    and centers; and the card's bf16 loss against its float32 one."""
    import numpy as np
    import torch

    from vit_cnn_tpu_torch.data import get_dataset
    from vit_cnn_tpu_torch.models.registry import get_model
    from vit_cnn_tpu_torch.tools import flagship_step

    scene = tuple(x[:40, :200] for x in get_dataset("Synthetic", tmp)[:3])
    img1, img2, _ = scene
    n_classes = int(SCENE["VCT_SYN_CLASSES"])

    def one_step(device, bf16):
        trainer, step_args = flagship_step(scene, state, device, 32,
                                           bf16=bf16, seed=SEED)
        loss = trainer._step(*step_args)
        model = trainer.model
        grads = {k: p.grad.detach().cpu() for k, p in
                 model.named_parameters()}
        stats = {k: v.detach().cpu() for k, v in model.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}
        return float(loss), grads, stats

    loss_cpu, g_cpu, s_cpu = one_step("cpu", False)
    loss_gpu, g_gpu, s_gpu = one_step("cuda", False)
    loss_b16 = one_step("cuda", True)[0]
    floor = GRAD_ATOL * max(float(g.norm()) for g in g_cpu.values())
    worst_g = max((float((g_gpu[k] - g).norm()) / (GRAD_TOL * float(g.norm())
                                                  + floor), k)
                  for k, g in g_cpu.items())
    worst_s = max((float((s_gpu[k] - v).abs().max())
                   / (STAT_TOL * float(v.abs().max())), k)
                  for k, v in s_cpu.items())
    dl = abs(loss_gpu - loss_cpu)
    db = abs(loss_b16 - loss_gpu) / abs(loss_gpu)
    print("[train-crop] loss card f32 {:.6f} cpu f32 {:.6f} |diff| {:.2e}"
          .format(loss_gpu, loss_cpu, dl), flush=True)
    print("[train-crop] {} gradients: worst ||diff|| is {:.3f} of its limit "
          "({}; limit {:g} x ||cpu|| + {:.2e})".format(
              len(g_cpu), worst_g[0], worst_g[1], GRAD_TOL, floor),
          flush=True)
    print("[train-crop] {} BN statistics: worst max|diff| is {:.3f} of its "
          "limit ({}; limit {:g} x max|cpu|)".format(
              len(s_cpu), worst_s[0], worst_s[1], STAT_TOL), flush=True)
    print("[train-crop] card bf16 loss {:.6f}: {:.2%} from f32 (limit "
          "{:.0%})".format(loss_b16, db, BF16_LOSS_TOL), flush=True)

    # each Mamba backbone alone, card against CPU, a seeded cotangent
    model = get_model("Multimodality_Mamba", n_classes=n_classes,
                      n_bands=(img1.shape[2], img2.shape[2]))[0]
    model.load_state_dict(state)
    rng = np.random.RandomState(SEED)
    worst_b = (0.0, "")
    for blk in ("hsi1", "hsi2"):
        net = getattr(model, blk).global_view
        side = int(round(net.pos_embed.shape[1] ** 0.5))
        x = rng.randn(32, side, side, net.embed_dims).astype(np.float32)
        cot = rng.randn(32, side, side, net.embed_dims).astype(np.float32)
        grads = {}
        for device in ("cpu", "cuda"):
            net.to(device).zero_grad(set_to_none=True)
            xt = torch.tensor(x, device=device, requires_grad=True)
            net(xt).backward(torch.tensor(cot, device=device))
            # copies: moving the module to the card moves its grads too
            grads[device] = {"input": xt.grad.to("cpu", copy=True), **{
                k: p.grad.to("cpu", copy=True)
                for k, p in net.named_parameters()}}
        for k, want in grads["cpu"].items():
            ratio = float((grads["cuda"][k] - want).abs().max()) / (
                BACKBONE_TOL * float(want.abs().max()))
            worst_b = max(worst_b, (ratio, "{}.{}".format(blk, k)))
    print("[train-crop] Mamba backbones alone: worst max|diff| is {:.3f} of "
          "its limit ({}; limit {:g} x max|cpu|)".format(
              worst_b[0], worst_b[1], BACKBONE_TOL), flush=True)
    if dl > 1e-3 * abs(loss_cpu) or worst_g[0] > 1.0 or worst_s[0] > 1.0 \
            or worst_b[0] > 1.0 or db > BF16_LOSS_TOL:
        raise Failed("the card's train step disagrees with the CPU's")


def phase_zoo(tmp):
    """The zoo's --serve path at full width; returns each model's kernel
    launches."""
    import numpy as np

    from vit_cnn_tpu_torch.cli import build_parser, run_serve
    from vit_cnn_tpu_torch.data import get_dataset
    from vit_cnn_tpu_torch.models.registry import MODELS
    from vit_cnn_tpu_torch.ops import _build

    img1, img2 = get_dataset("Synthetic", tmp)[:2]
    h, w = img1.shape[:2]
    n_bands = (img1.shape[2], img2.shape[2])
    n_classes = int(SCENE["VCT_SYN_CLASSES"])
    counts = {}
    for name in ZOO:
        p = MODELS[name].patch_size
        windows = (h - p + 1) * (w - p + 1)
        n_req = MHST_REQUESTS if name == "MHST" else 1
        out = os.path.join(tmp, "{}.npy".format(name))
        requests = [{}] * (n_req - 1) + [{"out": out}, {"cmd": "quit"}]
        args = build_parser().parse_args([
            "--dataset", "Synthetic", "--folder", tmp, "--model", name,
            "--bf16", "--serve", "--seed", str(SEED)])
        state = _seeded_state(name, n_bands, n_classes)
        in_s = io.StringIO("\n".join(json.dumps(r) for r in requests)
                           + "\n")
        out_s = io.StringIO()
        _build.launches.clear()
        served = run_serve(args, in_stream=in_s, out_stream=out_s,
                           state_dict=state)
        counts[name] = dict(_build.launches)
        resps = [json.loads(l) for l in out_s.getvalue().splitlines() if l]
        for r in resps:
            print("[zoo] {} {:.3f} s/request, {:.0f} windows/s ({} windows)"
                  .format(name, r["seconds"], windows / r["seconds"], windows)
                  if r.get("ok") else "[zoo] {} {}".format(name, r),
                  flush=True)
        if served != n_req or len(resps) != n_req or not all(
                r["ok"] for r in resps):
            raise Failed("{} did not answer {} requests ok".format(name,
                                                                  n_req))
        probs = np.load(out)
        finite = bool(np.isfinite(probs).all())
        print("[zoo] {} map {} finite={} max|p|={:.4f}".format(
            name, probs.shape, finite, float(np.abs(probs).max())),
            flush=True)
        if probs.shape != (h, w, n_classes) or not finite:
            raise Failed("bad {} map".format(name))
        want = {k: n * n_req for k, n in zip(HEADS, ZOO_LAUNCHES[name])}
        got = {k: counts[name].get(k, 0) for k in HEADS}
        others = {k: c for k, c in counts[name].items() if k not in HEADS}
        print("[zoo] {} launches {} (expected {})".format(
            name, json.dumps(counts[name]), json.dumps(want)), flush=True)
        if got != want or others:
            raise Failed("{}: kernel launches {} differ from {}".format(
                name, counts[name], want))
    return counts


def phase_zoo_crop(tmp):
    """Each zoo model on a 12 x 64 crop: card float32 and bf16 against the
    CPU's float32 plain path, the flagship crop's limits."""
    import numpy as np

    from vit_cnn_tpu_torch.data import get_dataset
    from vit_cnn_tpu_torch.infer.fullscene import full_scene_probabilities
    from vit_cnn_tpu_torch.models.registry import get_model

    img1, img2 = (x[:12, :64] for x in get_dataset("Synthetic", tmp)[:2])
    n_bands = (img1.shape[2], img2.shape[2])
    n_classes = int(SCENE["VCT_SYN_CLASSES"])
    failed = []
    for name in ZOO:
        state = _seeded_state(name, n_bands, n_classes)

        def serve(device, bf16):
            model, _, hp = get_model(name, n_classes=n_classes,
                                     n_bands=n_bands)
            model.load_state_dict(state)
            model.to(device).eval()
            selects = []          # MHST: every head-select decision
            for m in model.modules():
                if hasattr(m, "head_select"):
                    m.head_select.register_forward_hook(
                        lambda mod, a, out: selects.append(
                            (out > 0).cpu().flatten()))
            probs = full_scene_probabilities(model, img1, img2,
                                             dict(hp, bf16=bf16))
            sel = (np.concatenate([x.numpy() for x in selects]) if selects
                   else None)
            return probs, sel, hp["patch_size"]

        cpu, sel_cpu, p = serve("cpu", False)
        f32, sel_f32, _ = serve("cuda", False)
        b16, sel_b16, _ = serve("cuda", True)
        inner = (slice(p // 2, p // 2 + 12 - p + 1),
                 slice(p // 2, p // 2 + 64 - p + 1))
        scale = max(1.0, float(np.abs(cpu).max()))
        d32 = float(np.abs(f32 - cpu).max())
        d16 = float(np.abs(b16 - cpu).max())
        agree16 = float((b16[inner].argmax(-1) == cpu[inner].argmax(-1))
                        .mean())
        print("[zoo-crop] {}: card f32 vs cpu f32 max|diff| {:.3e} (limit "
              "{:.1e}); card bf16 vs cpu f32 max|diff| {:.3e}, argmax "
              "agreement {:.4f} (limit 0.99) over {} windows".format(
                  name, d32, CROP_TOL * scale, d16, agree16,
                  cpu[inner].shape[0] * cpu[inner].shape[1]), flush=True)
        if sel_cpu is not None:
            print("[zoo-crop] {}: head selections differing from the CPU's: "
                  "card f32 {} of {}, card bf16 {} of {}".format(
                      name, int((sel_f32 != sel_cpu).sum()), sel_cpu.size,
                      int((sel_b16 != sel_cpu).sum()), sel_cpu.size),
                  flush=True)
        if d32 > CROP_TOL * scale or agree16 < 0.99:
            failed.append(name)
    if failed:
        raise Failed("zoo crop maps disagree with the CPU plain path: {}"
                     .format(failed))


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    os.environ.update(SCENE)      # the Synthetic registry reads these
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        import vit_cnn_tpu_torch  # noqa: F401
    except ImportError as e:
        print("chip_smoke: the port is not beside this script: {}".format(e),
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        card = phase_device()
        print("[kernels]", flush=True)
        rows = phase_kernels()
        phase_adjoints(rows)
        sweep_counts = phase_variants(rows)
        with tempfile.TemporaryDirectory() as tmp:
            counts, _, state = phase_slice(tmp)
            phase_crop(tmp, state)
            train_counts, steady = phase_train(tmp, state)
            phase_train_crop(tmp, state)
            zoo_counts = phase_zoo(tmp)
            phase_zoo_crop(tmp)
    except Failed as e:
        print("chip_smoke: FAILED: {}".format(e), file=sys.stderr)
        return 1

    sources = {
        "selective_scan": ("vit_cnn_tpu_torch/csrc/selective_scan_fwd.cu",
                           "vit_cnn_tpu/ops/selective_scan.py:60"),
        "dir_conv_silu": ("vit_cnn_tpu_torch/csrc/dirstream.cu",
                          "vit_cnn_tpu/ops/dirstream.py:104"),
        "inv_perm_weighted_sum": ("vit_cnn_tpu_torch/csrc/dirstream.cu",
                                  "vit_cnn_tpu/ops/dirstream.py:308"),
        "fused_attention": ("vit_cnn_tpu_torch/csrc/attention.cu",
                            "vit_cnn_tpu/ops/attention.py:34"),
        "selective_scan_backward": (
            "vit_cnn_tpu_torch/csrc/selective_scan_bwd.cu",
            "vit_cnn_tpu/ops/selective_scan.py:215"),
        "dir_conv_silu_backward": ("vit_cnn_tpu_torch/csrc/dirstream_bwd.cu",
                                   "vit_cnn_tpu/ops/dirstream.py:224"),
        "inv_perm_weighted_sum_backward": (
            "vit_cnn_tpu_torch/csrc/dirstream_bwd.cu",
            "vit_cnn_tpu/ops/dirstream.py:377"),
        "fused_attention_heads": ("vit_cnn_tpu_torch/csrc/heads_attention.cu",
                                  "vit_cnn_tpu/ops/attention.py:108"),
        "pooled_heads_attention": (
            "vit_cnn_tpu_torch/csrc/heads_attention.cu",
            "vit_cnn_tpu/ops/attention.py:314"),
        "selective_scan_tiled": ("vit_cnn_tpu_torch/csrc/selective_scan.cu",
                                 "perf/scan_sweep.py:47"),
        "selective_scan_batch_major": (
            "vit_cnn_tpu_torch/csrc/scan_variants.cu",
            "perf/scan_bm_sweep.py:27"),
        "heads_attention_mma": ("vit_cnn_tpu_torch/csrc/heads_variants.cu",
                                "perf/mhst_attn_variants.py:111"),
        "heads_attention_outer": ("vit_cnn_tpu_torch/csrc/heads_variants.cu",
                                  "perf/mhst_attn_vpu.py:55"),
    }
    # the probe variants each row 12 / 13 kernel also stands for
    # (V3: F, G; V4: H, C, E, and A and B, whose float32 dots and float32 P
    # are V4's arithmetic on bf16 inputs, not V3's bf16 operands)
    also = {"heads_attention_mma": ["perf/mhst_attn_variants.py:90",
                                    "perf/mhst_attn_vpu.py:79"],
            "heads_attention_outer": ["perf/mhst_attn_variants.py:41",
                                      "perf/mhst_attn_variants.py:58",
                                      "perf/mhst_attn_variants.py:74",
                                      "perf/mhst_attn_variants.py:138"]}
    # launches: the flagship forward kernels' count from its serving run,
    # the adjoints' from the training run, K8 and K9 from the zoo's
    # serving runs, the variants' from the sweep (each run's counts were
    # set to 0 just before it); launches_by_path has all four paths
    zoo = {k: sum(c.get(k, 0) for c in zoo_counts.values())
           for k in sources}
    paths = {"serve": counts, "train": train_counts, "serve_zoo": zoo,
             "sweep": sweep_counts}
    table = [dict(name=name, route="cuda", source=src, replaces=rep,
                  launches=paths["train" if name in ADJOINTS else
                                 "serve_zoo" if name in HEADS else
                                 "sweep" if name in VARIANTS else
                                 "serve"].get(name, 0),
                  launches_by_path={k: c.get(name, 0)
                                    for k, c in paths.items()},
                  **({"also_replaces": also[name]} if name in also else {}),
                  **rows[name])
             for name, (src, rep) in sources.items()]
    print("[train] {}".format(json.dumps(steady)), flush=True)
    print(card, flush=True)                  # nvidia-smi name, power.limit
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
