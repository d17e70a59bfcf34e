#!/usr/bin/env python3
"""Smoke run of the PyTorch port (vit_cnn_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero before
the result lines:

1. device  — the card (nvidia-smi name and power limit), torch and CUDA
   versions, and the build of the kernels from csrc/.
2. kernels — each hand-written kernel (K1 selective scan, K2 dir_conv_silu,
   K3 inv_perm_weighted_sum, K4 attention) against its plain PyTorch
   version on the card, at the flagship's serving shapes and one ragged
   batch, in float32 (tight) and bfloat16 (outputs round to bf16), with
   median times of kernel and plain version (CUDA events).
3. slice   — the port's ``--serve`` daemon on the Synthetic scene at
   Houston2013 size (349 x 1905, 144 + 1 bands, 15 classes) under the bf16
   policy, with seeded random weights loaded through convert.py: three
   requests, seconds and windows/s each, a finite (349, 1905, 15) map,
   and every kernel's launch count in that run.
4. crop    — a 12 x 64 crop of the scene served on the card (kernels,
   float32 and bf16) and on the CPU in float32 (plain versions).

Then one JSON line with the kernel table, and as the last line
``{"ok": true, "device": {...}}``.
"""

import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

SCENE = {"VCT_SYN_H": "349", "VCT_SYN_W": "1905", "VCT_SYN_BANDS": "144",
         "VCT_SYN_CLASSES": "15"}
SEED = 0
BAND_WINDOWS = 4 * 1897       # windows per band at --infer_chunk 8192
RAGGED = 1001
TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2e-2, 2e-2)}   # (rtol, atol)
CROP_TOL = 1e-3               # max|diff| of the f32 crop map, relative


class Failed(Exception):
    pass


def _median_ms(fn, reps=10):
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _compare(name, got, want, dtype_name):
    """max|diff| of the kernel's output against the plain version's, held
    to |d| <= atol + rtol * |want| elementwise."""
    import torch

    rtol, atol = TOL[dtype_name]
    outs_g = got if isinstance(got, tuple) else (got,)
    outs_w = want if isinstance(want, tuple) else (want,)
    worst, ok = 0.0, True
    for g, w in zip(outs_g, outs_w):
        if g.numel() == 0:
            continue
        g, w = g.float(), w.float()
        d = (g - w).abs()
        worst = max(worst, float(d.max()))
        ok &= bool(torch.isfinite(g).all()) and bool(
            (d <= atol + rtol * w.abs()).all())
    print("  {:<44s} {:<8s} max|diff| {:.3e}  (rtol {:g}, atol {:g})  {}"
          .format(name, dtype_name, worst, rtol, atol,
                  "ok" if ok else "FAIL"), flush=True)
    if not ok:
        raise Failed("{} {} disagrees with its plain version".format(
            name, dtype_name))
    return worst


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


def _scan_inputs(g, ns, L, d, n, b, dtype):
    import torch

    dev = "cuda"
    u = torch.randn((ns, L, d, b), generator=g, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn((ns, L, d, b), generator=g, device=dev) - 2.0)
    B = torch.randn((ns, L, n, b), generator=g, device=dev)
    C = torch.randn((ns, L, n, b), generator=g, device=dev)
    A = -torch.exp(torch.log(torch.arange(1, n + 1, device=dev,
                                          dtype=torch.float32))[None]
                   .expand(d, n) + 0.1 * torch.randn((d, n), generator=g,
                                                     device=dev))
    D = 1.0 + 0.1 * torch.randn((d,), generator=g, device=dev)
    return (u.to(dtype), dt.to(dtype), A, B.to(dtype), C.to(dtype), D)


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

    from vit_cnn_tpu_torch.ops import attention, dirstream, selective_scan

    g = torch.Generator(device="cuda").manual_seed(SEED)
    stages = [(81, 72), (49, 128)]          # (L, d) of hsi1 and hsi2
    rows = {}

    def record(key, err, dtype_name, ms=None, plain_ms=None):
        row = rows.setdefault(key, {"max_abs_err": 0.0,
                                    "max_abs_err_bf16": 0.0})
        field = "max_abs_err" if dtype_name == "float32" else \
            "max_abs_err_bf16"
        row[field] = max(row[field], err)
        if ms is not None:
            row["ms"], row["plain_ms"] = ms, plain_ms

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        timed = dtype == torch.bfloat16     # the serving dtype
        for (L, d) in stages:
            for b in (BAND_WINDOWS, RAGGED):
                main = timed and b == BAND_WINDOWS and L == 81
                # K1: forward over the 6 base streams, reverse over the 4
                for ns, rev in ((6, False), (4, True)):
                    args = _scan_inputs(g, ns, L, d, 16, b, dtype)
                    got = selective_scan.selective_scan(*args, reverse=rev)
                    want = selective_scan.selective_scan_reference(
                        *args, reverse=rev)
                    err = _compare("K1 scan ns={} L={} d={} b={}{}".format(
                        ns, L, d, b, " rev" if rev else ""), got, want, dn)
                    t = p = None
                    if main and not rev:
                        t = _median_ms(lambda: selective_scan.selective_scan(
                            *args, reverse=rev))
                        p = _median_ms(
                            lambda: selective_scan.selective_scan_reference(
                                *args, reverse=rev), reps=3)
                    record("selective_scan", err, dn, t, p)
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
                t = p = None
                if main:
                    t = _median_ms(lambda: dirstream.dir_conv_silu(
                        u, cw, cb, orders, rev_rows))
                    p = _median_ms(lambda: dirstream.dir_conv_silu_reference(
                        u, cw, cb, orders, rev_rows), reps=3)
                record("dir_conv_silu", err, dn, t, p)
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
                t = p = None
                if main:
                    t = _median_ms(lambda: dirstream.inv_perm_weighted_sum(
                        yf, yr, wf, wr, inv, rev_rows))
                    p = _median_ms(
                        lambda: dirstream.inv_perm_weighted_sum_reference(
                            yf, yr, wf, wr, inv, rev_rows), reps=3)
                record("inv_perm_weighted_sum", err, dn, t, p)
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
                t = p = None
                if timed and G == BAND_WINDOWS and lq == 49:
                    t = _median_ms(lambda: attention.fused_attention(
                        q, k, v, 1.0))
                    p = _median_ms(lambda: attention.attention_reference(
                        q, k, v, 1.0))
                record("fused_attention", err, dn, t, p)
    torch.cuda.synchronize()
    return rows


def _flagship_state_dict(n_bands, n_classes):
    from vit_cnn_tpu_torch.convert import (flax_to_state_dict,
                                           seeded_variables,
                                           state_dict_to_flax)
    from vit_cnn_tpu_torch.models.registry import get_model

    model = get_model("Multimodality_Mamba", n_classes=n_classes,
                      n_bands=n_bands)[0]
    return flax_to_state_dict(
        seeded_variables(state_dict_to_flax(model), SEED), model)


def phase_slice(tmp):
    import numpy as np

    from vit_cnn_tpu.data.registry import get_dataset
    from vit_cnn_tpu_torch.cli import build_parser, run_serve
    from vit_cnn_tpu_torch.ops import _build

    img1, img2, gt = get_dataset("Synthetic", tmp)[:3]
    h, w = img1.shape[:2]
    n_classes = int(SCENE["VCT_SYN_CLASSES"])
    windows = (h - 8) * (w - 8)
    print("[slice] scene {} x {} x {} + {}, {} windows".format(
        h, w, img1.shape[2], img2.shape[2], windows), flush=True)
    state = _flagship_state_dict((img1.shape[2], img2.shape[2]), n_classes)
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

    from vit_cnn_tpu.data.registry import get_dataset
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
        with tempfile.TemporaryDirectory() as tmp:
            counts, _, state = phase_slice(tmp)
            phase_crop(tmp, state)
    except Failed as e:
        print("chip_smoke: FAILED: {}".format(e), file=sys.stderr)
        return 1

    sources = {
        "selective_scan": ("vit_cnn_tpu_torch/csrc/selective_scan.cu",
                           "vit_cnn_tpu/ops/selective_scan.py:60"),
        "dir_conv_silu": ("vit_cnn_tpu_torch/csrc/dirstream.cu",
                          "vit_cnn_tpu/ops/dirstream.py:104"),
        "inv_perm_weighted_sum": ("vit_cnn_tpu_torch/csrc/dirstream.cu",
                                  "vit_cnn_tpu/ops/dirstream.py:308"),
        "fused_attention": ("vit_cnn_tpu_torch/csrc/attention.cu",
                            "vit_cnn_tpu/ops/attention.py:34"),
    }
    table = [dict(name=name, route="cuda", source=src, replaces=rep,
                  launches=counts.get(name, 0), **rows[name])
             for name, (src, rep) in sources.items()]
    print(card, flush=True)                  # nvidia-smi name, power.limit
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
