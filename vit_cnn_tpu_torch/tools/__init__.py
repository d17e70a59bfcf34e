"""Measurement scripts for the card, each run from the repo root:

  python -m vit_cnn_tpu_torch.tools.profile_train [--model M] # step profile
  python -m vit_cnn_tpu_torch.tools.train_conditioning  # gradient spread
  python -m vit_cnn_tpu_torch.tools.profile_serve       # serving profile
  python -m vit_cnn_tpu_torch.tools.scan_sweep          # K1's variants
  python -m vit_cnn_tpu_torch.tools.heads_attn_variants # K8's variants
  python -m vit_cnn_tpu_torch.tools.scan_ab OTHER.cu    # old K1 vs K1, V1
  python -m vit_cnn_tpu_torch.tools.kernel_ablation KIND A.cu ... # K1-K7, V4
  python -m vit_cnn_tpu_torch.tools.mesh_check --ranks 4   # the mesh, 4 cards
  python -m vit_cnn_tpu_torch.tools.bench_models [MODEL ...] # per-model table

The first three and ``bench_models`` build their models as
``chip_smoke.py`` does: at
Houston2013 width on the Synthetic scene at 349 x 1905, with the seeded
weights of ``convert.seeded_state_dict`` (:func:`model_state`);
``profile_train`` takes ``--model`` (the flagship by default), and
``profile_serve`` model names (every registered model by default). The two
sweeps time the scan's and head-last attention's variants
(ops/scan_variants.py, ops/heads_variants.py) at the serving shapes and
the probes' shapes against their bounds (:func:`bound`, with CUDA-event medians,
:func:`median_ms`); ``chip_smoke.py`` calls the same functions.
``scan_ab`` times an older commit's K1 beside this checkout's K1 and V1
at K1's plan (one kernel template) on the same inputs
(:func:`scan_inputs`), bit for bit and SASS against SASS;
``kernel_ablation`` builds copies of K1-K7 and V4 (variants, or another
commit's file) and times them side by side (KIND: scan, conv, sum,
attn, scan_bwd, conv_bwd, sum_bwd or outer). ``bench_models``, the twin of the
JAX package's ``perf/bench_models.py``, gives each of the 14 registry
models a serving row and a train row (median and spread of repeated
runs, the train step's device time beside its host time), stamped with
:func:`card_line` and :func:`stamp`.
"""

from __future__ import annotations

import hashlib
import os
import statistics
import subprocess
import tempfile
from pathlib import Path
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


def stamp() -> str:
    """The code a measurement ran: ``git <sha>`` (``+dirty`` where the
    port's package differs from that commit) when the checkout is a git
    work tree, and always ``tree <hash>``, a sha256 of the package's
    sources (``.py``, ``.cu``, ``.cuh``), which a copy without ``.git``
    has too."""
    pkg = Path(__file__).resolve().parents[1]
    root = pkg.parent
    h = hashlib.sha256()
    for f in sorted(pkg.rglob("*")):
        if f.suffix in (".py", ".cu", ".cuh"):
            h.update(str(f.relative_to(root)).encode())
            h.update(f.read_bytes())
    tree = "tree " + h.hexdigest()[:16]

    def git(*args):
        try:
            out = subprocess.run(["git", "-C", str(root), *args],
                                 capture_output=True, text=True, timeout=60)
        except OSError:
            return None
        return out.stdout.strip() if out.returncode == 0 else None

    if git("rev-parse", "--show-toplevel") != str(root):
        return tree
    dirty = git("status", "--porcelain", "--", pkg.name)
    return "git {}{} {}".format(git("rev-parse", "HEAD"),
                                "+dirty" if dirty else "", tree)


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


def train_step(scene, state, device, batch: int,
               model: str = "Multimodality_Mamba", bf16: bool = False,
               flip: bool = False, seed: int = 0, radiation: bool = False,
               mixture: bool = False, debug_nans: bool = False):
    """A Trainer of the registered ``model`` on ``device`` from ``state``
    (on the PCA of ``scene``'s HSI for a PCA model), and one batch of
    centers (the first of its seeded shuffle) with its ``valid`` mask and
    a zero loss sum: ``trainer._step(*args)`` runs one step (the zoo's
    dropout and Gumbel noise from ``trainer.noise``, the trainer's
    generator unless the caller sets another source). ``flip``,
    ``radiation`` and ``mixture`` are the augmentations, ``debug_nans``
    the NaN checks of ``--debug_nans``."""
    from ..models.registry import get_model
    from ..pipeline.patches import AugmentConfig, PatchPipeline
    from ..train.loop import Trainer

    from ..data.normalize import apply_pca

    img1, img2, gt = scene
    n_classes = int(SCENE["VCT_SYN_CLASSES"])
    net, _, hp = get_model(
        model, dataset="Synthetic", n_classes=n_classes,
        n_bands=(img1.shape[2], img2.shape[2]), ignored_labels=[0],
        batch_size=batch, epoch=1, bf16=bf16, flip_augmentation=flip,
        debug_nans=debug_nans)
    if hp["applyPCA"]:                  # HCTnet trains on the scene's PCA
        img1 = apply_pca(img1, hp["pca_components"])
    net.load_state_dict(state)
    net.to(device)
    pipe = PatchPipeline(img1, img2, gt, hp["patch_size"], [0], n_classes,
                         augment=AugmentConfig(flip=flip, radiation=radiation,
                                               mixture=mixture),
                         device=device)
    trainer = Trainer(net, hp, pipe, seed=seed)
    centers = torch.as_tensor(
        pipe.epoch_order(np.random.RandomState(seed))[:batch], device=device)
    args = (centers, torch.ones(batch, device=device),
            torch.zeros((), device=device))
    return trainer, args


def model_state(scene, model: str = "Multimodality_Mamba", seed: int = 0):
    """The seeded state_dict of the registered ``model`` for ``scene``'s
    bands."""
    from ..convert import seeded_state_dict
    from ..models.registry import get_model

    img1, img2, _ = scene
    net = get_model(model, n_classes=int(SCENE["VCT_SYN_CLASSES"]),
                    n_bands=(img1.shape[2], img2.shape[2]))[0]
    return seeded_state_dict(net, seed)
