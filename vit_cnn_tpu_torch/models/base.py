"""Shared conventions of the zoo (port of :mod:`vit_cnn_tpu.models.base`).

Every model takes ``model(hsi, lidar)`` with hsi (B, P, P, C1) and lidar
(B, P, P, C2), channel-last, and returns logits (or class scores), or a
tuple whose first entry they are. Patch-1 models receive (B, 1, 1, C) and
squeeze it themselves.
"""

from __future__ import annotations

import torch


def squeeze_pixel(x: torch.Tensor) -> torch.Tensor:
    """(B, 1, 1, C) -> (B, C); passthrough for (B, C)."""
    return x[:, 0, 0, :] if x.dim() == 4 else x

