"""The benchmark's scene and labels, made on the device from the seed.

A seeded copy of the recipe of the port's synthetic loader
(``vit_cnn_tpu_torch/data/registry.py`` ``_synthetic_loader``): every
pixel belongs to a class stripe, its HSI spectrum is the class mean plus
noise and its LiDAR band the class value plus noise. Of the interior
pixels of each class, ``labelled_per_class`` are labelled and the first
``train_per_class`` of those form the training split, so every seed gives
the same sizes and counts. Everything is drawn in a few large calls on
the device; the arrays come to the host once, in float32, since the
program takes host scenes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def make(spec: Dict, seed: int, device, margin: int) -> Dict[str, np.ndarray]:
    """``img1`` (H, W, hsi_bands), ``img2`` (H, W, lidar_bands) float32,
    ``gt`` (H, W) int64 with the labelled pixels (0 elsewhere) and
    ``gt_train`` with the training split only. Labels are 1..classes;
    labelled pixels lie ``margin`` or more pixels inside every edge."""
    h, w = int(spec["height"]), int(spec["width"])
    bands, lbands = int(spec["hsi_bands"]), int(spec["lidar_bands"])
    labelled = [int(c) for c in spec["labelled_per_class"]]
    train = [int(c) for c in spec["train_per_class"]]
    n_real = len(labelled)
    g = torch.Generator(device=device).manual_seed(int(seed))
    yy = torch.arange(h, device=device)[:, None]
    xx = torch.arange(w, device=device)[None, :]
    cls = 1 + ((xx * n_real) // w + (yy * 3) // h) % n_real      # (H, W)
    means = torch.rand((n_real + 1, bands), generator=g, device=device)
    img1 = means[cls] + 0.05 * torch.randn((h, w, bands), generator=g,
                                           device=device)
    img2 = (cls[..., None].float() / (n_real + 1)
            + 0.05 * torch.randn((h, w, lbands), generator=g, device=device))
    inside = torch.zeros((h, w), dtype=torch.bool, device=device)
    inside[margin:h - margin, margin:w - margin] = True
    # one random key a pixel orders each class's interior pixels
    key = torch.rand((h, w), generator=g, device=device)
    gt = torch.zeros((h, w), dtype=torch.int64, device=device)
    gt_train = torch.zeros_like(gt)
    flat_cls, flat_in, flat_key = cls.reshape(-1), inside.reshape(-1), \
        key.reshape(-1)
    for c in range(1, n_real + 1):
        idx = torch.nonzero(flat_in & (flat_cls == c))[:, 0]
        if len(idx) < labelled[c - 1]:
            raise ValueError("class {} has {} interior pixels, {} asked"
                             .format(c, len(idx), labelled[c - 1]))
        idx = idx[torch.argsort(flat_key[idx])]
        gt.view(-1)[idx[:labelled[c - 1]]] = c
        gt_train.view(-1)[idx[:train[c - 1]]] = c
    return {"img1": img1.cpu().numpy(), "img2": img2.cpu().numpy(),
            "gt": gt.cpu().numpy(), "gt_train": gt_train.cpu().numpy()}
