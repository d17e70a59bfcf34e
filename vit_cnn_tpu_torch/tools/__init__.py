"""Measurement scripts for the card, each run from the repo root:

  python -m vit_cnn_tpu_torch.tools.profile_train       # step profile
  python -m vit_cnn_tpu_torch.tools.train_conditioning  # gradient spread

Both build the flagship as ``chip_smoke.py`` does: ``Multimodality_Mamba``
at Houston2013 width on the Synthetic scene at 349 x 1905, with the seeded
weights of ``convert.seeded_state_dict``.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np
import torch

SCENE = {"VCT_SYN_H": "349", "VCT_SYN_W": "1905", "VCT_SYN_BANDS": "144",
         "VCT_SYN_CLASSES": "15"}


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
