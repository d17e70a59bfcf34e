"""Measurement scripts for the card, each run from the repo root:

  python -m vit_cnn_tpu_torch.tools.profile_train       # step profile
  python -m vit_cnn_tpu_torch.tools.train_conditioning  # gradient spread
  python -m vit_cnn_tpu_torch.tools.profile_serve       # serving profile
  python -m vit_cnn_tpu_torch.tools.scan_sweep          # K1's variants
  python -m vit_cnn_tpu_torch.tools.heads_attn_variants # K8's variants
  python -m vit_cnn_tpu_torch.tools.scan_ab OTHER.cu    # old K1 vs V1 (8, 8)
  python -m vit_cnn_tpu_torch.tools.kernel_ablation KIND A.cu ... # K1-K7 copies

The first three build their models as ``chip_smoke.py`` does: at
Houston2013 width on the Synthetic scene at 349 x 1905, with the seeded
weights of ``convert.seeded_state_dict``. The two sweeps time the scan's
and head-last attention's variants (ops/scan_variants.py,
ops/heads_variants.py) at the serving shapes and the probes' shapes
against their bounds (:func:`bound`, with CUDA-event medians,
:func:`median_ms`); ``chip_smoke.py`` calls the same functions.
``scan_ab`` times an older commit's K1 beside this checkout's V1 (8, 8),
the first K1 kept as a template, on the same inputs (:func:`scan_inputs`);
``kernel_ablation`` builds copies of K1-K7 (variants, or another
commit's file) and times them side by side (KIND: scan, conv, sum,
attn, scan_bwd, conv_bwd or sum_bwd).
"""

from __future__ import annotations

import os
import statistics
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np
import torch

SCENE = {"VCT_SYN_H": "349", "VCT_SYN_W": "1905", "VCT_SYN_BANDS": "144",
         "VCT_SYN_CLASSES": "15"}
# peaks of the H100 SXM data sheet, for the bounds: HBM bytes/s, special-
# function-unit exps/s (16 / clock / SM x 132 SMs x 1.98 GHz), FLOP/s by
# input type (bf16 on the tensor cores, float32 on the CUDA cores)
PEAK_BYTES, PEAK_EXPS = 3.35e12, 4.2e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# (rtol, atol) of a kernel against its plain version on the card: float32
# tight (another summation order than torch's); bf16 one bf16 step (both
# sides round a float32 result once)
TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2e-2, 2e-2)}


def median_ms(fn, reps: int = 10) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after 2 warm-up
    calls, in ms."""
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


def bound(tensors, dtype_name: str, exps: int = 0, flops: int = 0):
    """(bound_ms, bound_by) of one call: the larger of the bytes of its
    inputs and outputs (``tensors``, each read or written once) over the
    HBM rate and its operations over their peak rate (exps on the
    special-function units, FLOPs at the rate of the inputs' type)."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    t_bytes = nbytes / PEAK_BYTES
    t_ops = max(exps / PEAK_EXPS, flops / PEAK_FLOPS[dtype_name])
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


def scan_inputs(g, ns, L, d, n, b, dtype):
    """Lane-major (ns, L, d, b) / (ns, L, n, b) scan inputs on the card
    from the generator ``g``, with the flagship's A = -exp(A_log)."""
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


def all_ok(result: dict) -> bool:
    """Every variant of a sweep result within its tolerance."""
    return all(v["ok"] for v in result["variants"])


def compare(got, want, dtype_name: str):
    """(max|got - want|, every element finite and within atol + rtol
    |want|) for (rtol, atol) = ``TOL[dtype_name]``."""
    rtol, atol = TOL[dtype_name]
    g, w = got.float(), want.float()
    d = (g - w).abs()
    ok = bool(torch.isfinite(g).all()) and bool(
        (d <= atol + rtol * w.abs()).all())
    return (float(d.max()) if d.numel() else 0.0), ok


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi failed: " + smi.stderr.strip()


def load_scene(crop: Optional[Tuple[int, int]] = None):
    """(img1, img2, gt) of the Synthetic scene at Houston2013 size, or its
    top-left ``crop`` (rows, cols)."""
    from ..data import get_dataset

    os.environ.update(SCENE)
    with tempfile.TemporaryDirectory() as tmp:
        scene = get_dataset("Synthetic", tmp)[:3]
    if crop is not None:
        scene = tuple(x[:crop[0], :crop[1]] for x in scene)
    return scene


def flagship_step(scene, state, device, batch: int, bf16: bool = False,
                  flip: bool = False, seed: int = 0):
    """A Trainer of the flagship on ``device`` from ``state``, and one
    batch of centers (the first of its seeded shuffle) with its ``valid``
    mask and a zero loss sum: ``trainer._step(*args)`` runs one step."""
    from ..models.registry import get_model
    from ..pipeline.patches import AugmentConfig, PatchPipeline
    from ..train.loop import Trainer

    img1, img2, gt = scene
    n_classes = int(SCENE["VCT_SYN_CLASSES"])
    model, _, hp = get_model(
        "Multimodality_Mamba", dataset="Synthetic", n_classes=n_classes,
        n_bands=(img1.shape[2], img2.shape[2]), ignored_labels=[0],
        batch_size=batch, epoch=1, bf16=bf16, flip_augmentation=flip)
    model.load_state_dict(state)
    model.to(device)
    pipe = PatchPipeline(img1, img2, gt, hp["patch_size"], [0], n_classes,
                         augment=AugmentConfig(flip=flip), device=device)
    trainer = Trainer(model, hp, pipe, seed=seed)
    centers = torch.as_tensor(
        pipe.epoch_order(np.random.RandomState(seed))[:batch], device=device)
    args = (centers, torch.ones(batch, device=device),
            torch.zeros((), device=device))
    return trainer, args


def flagship_state(scene, seed: int = 0):
    """The seeded state_dict of the flagship for ``scene``'s bands."""
    from ..convert import seeded_state_dict
    from ..models.registry import get_model

    img1, img2, _ = scene
    model = get_model("Multimodality_Mamba",
                      n_classes=int(SCENE["VCT_SYN_CLASSES"]),
                      n_bands=(img1.shape[2], img2.shape[2]))[0]
    return seeded_state_dict(model, seed)
