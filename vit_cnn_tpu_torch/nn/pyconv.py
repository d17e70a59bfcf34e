"""Pyramidal convolution (port of :mod:`vit_cnn_tpu.nn.pyconv`, ref:
model/compare_method/MHST/PyConv2D.py): parallel bias-free grouped convs
at several kernel sizes, SAME padding (kernel // 2), each with
``planes // out_planes_div[i]`` outputs, concatenated along channels."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from .layers import Conv


class PyConv(nn.Module):
    def __init__(self, in_features: int, planes: int, kernels: Sequence[int],
                 out_planes_div: Sequence[int], groups: Sequence[int]):
        super().__init__()
        self.n = len(kernels)
        for i, (k, d, g) in enumerate(zip(kernels, out_planes_div, groups)):
            setattr(self, "branch{}".format(i),
                    Conv(in_features, planes // d, k, padding=k // 2,
                         groups=g, use_bias=False))

    def forward(self, x):
        return torch.cat([getattr(self, "branch{}".format(i))(x)
                          for i in range(self.n)], dim=-1)
