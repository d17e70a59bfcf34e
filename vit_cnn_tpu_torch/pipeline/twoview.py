"""Two-view batches for contrastive pretraining.

Port of :mod:`vit_cnn_tpu.pipeline.twoview` (the reference's
MultiModalX_all, ref: datasets.py:596-735). Every interior pixel is a
center, ignored labels included (``supervision="semi"``), and the class
table of mixture noise is built over those centers. View 1 is the raw
gather; view 2 takes the same flip/rotate on the HSI, the LiDAR and the
labels (folded into the gather, as in training), then radiation noise (p
0.1) and mixture noise (p 0.2) on the HSI, when configured. Without flip
view 2 is the raw gather too, noise aside (the reference crashes there,
QUIRKS.md).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .patches import (AugmentConfig, PatchPipeline, batch_codes,
                      gather_patches)


class TwoViewPipeline(PatchPipeline):
    """Yields (x1_v1, x1_v2, x2_v1, x2_v2, label) batches, the 5-tuple of
    ref: datasets.py:731-735."""

    def __init__(self, img1, img2, gt, patch_size, ignored_labels, n_classes,
                 augment: AugmentConfig = AugmentConfig(flip=True),
                 device="cpu"):
        super().__init__(img1, img2, gt, patch_size, ignored_labels,
                         n_classes, augment=augment, supervision="semi",
                         device=device)

    def make_views(self, generator: Optional[torch.Generator],
                   centers: torch.Tensor,
                   codes: Optional[torch.Tensor] = None,
                   draws: Optional[Dict[str, torch.Tensor]] = None):
        """The two views of a batch of centers and the raw center labels.
        ``codes`` and ``draws`` give view 2's flip/rotate codes and noise
        draws explicitly instead of drawing them from ``generator``;
        under an engaged mesh ``centers`` are the rank's rows and the
        draws the global batch's rows (pipeline/patches.py)."""
        p = self.patch_size
        v1_1 = gather_patches(self.scene1, centers, p)
        v2_1 = gather_patches(self.scene2, centers, p)
        lp = gather_patches(self.gt[..., None], centers, p)[..., 0]
        v1_2, v2_2, lp_2 = v1_1, v2_1, lp
        if self.augment_cfg.flip and p > 1:
            if codes is None:
                codes = batch_codes(generator, centers.shape[0])
            offsets = (self._grids[0][codes], self._grids[1][codes])
            v1_2 = gather_patches(self.scene1, centers, p, offsets)
            v2_2 = gather_patches(self.scene2, centers, p, offsets)
            lp_2 = gather_patches(self.gt[..., None], centers, p,
                                  offsets)[..., 0]
        v1_2 = self.add_noise(generator, v1_2, lp_2, draws)
        return v1_1, v1_2, v2_1, v2_2, lp[:, p // 2, p // 2]
