"""S2ENet in PyTorch (port of :mod:`vit_cnn_tpu.models.s2enet`, recovered
there from the reference's bytecode): spatial / spectral cross-modal
enhancement.

* two conv-BN-ReLU branches: HSI 128 -> 64 -> 32, LiDAR 8 -> 16 -> 32
  (3x3, pad 1),
* SAEM: sigmoid-gated 1x1 projections T1 / T2 to 16 channels, the
  spatial affinity (HW x HW) reduced over its first axis by a bias-free
  1-D conv (``dim_reduce``, (1, HW)) to a (H, W) gate on the HSI features,
* SEEM: the same with the channel affinity (C x C) to a per-channel gate
  on the LiDAR features,
* fusion 1x1 conv (64 -> 32) + BN + ReLU, average pool, Dense to the
  classes.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn.layers import (BatchNorm, Conv, ConvBNReLU, Dense,
                         adaptive_avg_pool, init_weight_)


class _GatedProj(nn.Module):
    """T1 / T2: 1x1 conv -> BN -> sigmoid."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, 1, init="kaiming_out")
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x):
        return torch.sigmoid(self.BatchNorm_0(self.Conv_0(x)))


class _DimReduce(nn.Module):
    """Holds an enhancement module's ``dim_reduce`` (1, n) parameter."""

    def __init__(self, n: int):
        super().__init__()
        self.dim_reduce = nn.Parameter(torch.empty(1, n))

    def reset_parameters(self, g: torch.Generator):
        init_weight_(self.dim_reduce.T, "lecun_normal", g)


class SpatialEnhanceModule(_DimReduce):
    """SAEM: x1 gated by a spatial affinity map with x2."""

    def __init__(self, in1: int, in2: int, inter_channels: int, size: int):
        super().__init__(size * size)
        self.T1 = _GatedProj(in1, inter_channels)
        self.T2 = _GatedProj(in2, inter_channels)

    def forward(self, x1, x2):
        b, h, w, _ = x1.shape
        t1 = self.T1(x1).reshape(b, h * w, -1)
        t2 = self.T2(x2).reshape(b, h * w, -1)
        # affinity (B, HW_i, HW_j) transposed, reduced over HW_j
        affinity = torch.einsum("bic,bjc->bji", t1, t2)
        gate = torch.einsum("oi,bij->boj", self.dim_reduce, affinity)
        return x1 * gate.reshape(b, h, w, 1)


class SpectralEnhanceModule(_DimReduce):
    """SEEM: x1 gated per channel by a channel affinity with x2."""

    def __init__(self, in1: int, in2: int, inter_channels: int,
                 inter_channels2: int):
        super().__init__(inter_channels2)
        self.T1 = _GatedProj(in1, inter_channels)
        self.T2 = _GatedProj(in2, inter_channels2)

    def forward(self, x1, x2):
        b, h, w, c1 = x1.shape
        t1 = self.T1(x1).reshape(b, h * w, -1)
        t2 = self.T2(x2).reshape(b, h * w, -1)
        affinity = torch.einsum("bic,bid->bdc", t1, t2)   # (B, C2', C1')
        gate = torch.einsum("oi,bij->boj", self.dim_reduce, affinity)
        return x1 * gate.reshape(b, 1, 1, c1)


class S2ENet(nn.Module):
    def __init__(self, n_bands1: int, n_bands2: int, n_classes: int,
                 patch_size: int):
        super().__init__()
        planes_a, planes_b = (128, 64, 32), (8, 16, 32)
        convs = []
        for n, planes in ((n_bands1, planes_a), (n_bands2, planes_b)):
            for f in planes:
                convs.append(ConvBNReLU(n, f, 3, padding=1))
                n = f
        for i, conv in enumerate(convs):
            setattr(self, "ConvBNReLU_{}".format(i), conv)
        self.SAEM = SpatialEnhanceModule(planes_a[2], planes_b[2],
                                         planes_a[2] // 2, patch_size)
        self.SEEM = SpectralEnhanceModule(planes_b[2], planes_a[2],
                                          planes_b[2], planes_a[2])
        self.fusion_conv = Conv(planes_a[2] + planes_b[2], planes_a[2], 1,
                                init="kaiming_out")
        self.fusion_bn = BatchNorm(planes_a[2])
        self.fc = Dense(planes_a[2], n_classes)

    def forward(self, hsi, lidar):
        x1, x2 = hsi, lidar
        for i in range(3):
            x1 = getattr(self, "ConvBNReLU_{}".format(i))(x1)
        for i in range(3, 6):
            x2 = getattr(self, "ConvBNReLU_{}".format(i))(x2)
        x = torch.cat([self.SAEM(x1, x2), self.SEEM(x2, x1)], dim=-1)
        x = torch.relu(self.fusion_bn(self.fusion_conv(x)))
        return self.fc(adaptive_avg_pool(x))
