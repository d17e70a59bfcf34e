"""FusAtNet in PyTorch (port of :mod:`vit_cnn_tpu.models.fusatnet`, ref:
model/compare_method/FusAtNet.py:10-186): dual-attention spectro-spatial
fusion at patch 11.

* HSI feature extractor ``hfe``: 6 conv units (3x3 SAME) -> 1024
  channels,
* spectral attention: two pooled residual units (VALID 2x2 max pools,
  11 -> 5 -> 2) -> convs -> max pool -> average pool to a (1, 1, 1024)
  gate on the HSI features,
* spatial attention ``spatial_am`` from the LiDAR: residual units of 128
  and 256 channels -> convs -> 1024, multiplied onto the HSI features,
* modality feature / attention towers ``mfe`` / ``mam`` on the concat
  [hsi, lidar, Ms, Mt], multiplied,
* classifier: 5 VALID 3x3 convs (11 -> 1) and a 1x1 conv to the classes.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn.layers import Conv, ConvBNReLU, adaptive_avg_pool, max_pool_2x2


class _ResUnit(nn.Module):
    """Residual_Unit2: conv-BN-ReLU, then one more added to it;
    Residual_Unit1 (``pooled``) ends with a VALID 2x2 max pool."""

    def __init__(self, in_features: int, features: int,
                 pooled: bool = False):
        super().__init__()
        self.pooled = pooled
        self.ConvBNReLU_0 = ConvBNReLU(in_features, features, 3, padding=1)
        self.ConvBNReLU_1 = ConvBNReLU(features, features, 3, padding=1)

    def forward(self, x):
        x = self.ConvBNReLU_0(x)
        x = self.ConvBNReLU_1(x) + x
        return max_pool_2x2(x) if self.pooled else x


class _ConvTower(nn.Module):
    """6 conv units (3x3 SAME): both feature extractors."""

    def __init__(self, in_features: int, out_features: int = 1024):
        super().__init__()
        for i, f in enumerate((256,) * 5 + (out_features,)):
            setattr(self, "ConvBNReLU_{}".format(i),
                    ConvBNReLU(in_features, f, 3, padding=1))
            in_features = f

    def forward(self, x):
        for i in range(6):
            x = getattr(self, "ConvBNReLU_{}".format(i))(x)
        return x


class _AttentionTower(nn.Module):
    """res (128) res (256) conv conv -> out_features (spatial / modality
    attention)."""

    def __init__(self, in_features: int, out_features: int = 1024):
        super().__init__()
        self._ResUnit_0 = _ResUnit(in_features, 128)
        self._ResUnit_1 = _ResUnit(128, 256)
        self.ConvBNReLU_0 = ConvBNReLU(256, 256, 3, padding=1)
        self.ConvBNReLU_1 = ConvBNReLU(256, out_features, 3, padding=1)

    def forward(self, x):
        x = self._ResUnit_1(self._ResUnit_0(x))
        return self.ConvBNReLU_1(self.ConvBNReLU_0(x))


class FusAtNet(nn.Module):
    def __init__(self, n_bands1: int, n_bands2: int, n_classes: int,
                 width: int = 1024):
        super().__init__()
        w = width
        self.hfe = _ConvTower(n_bands1, w)
        self._ResUnitPooled_0 = _ResUnit(n_bands1, 256, pooled=True)
        self._ResUnitPooled_1 = _ResUnit(256, 256, pooled=True)
        self.spatial_am = _AttentionTower(n_bands2, w)
        stacked = n_bands1 + n_bands2 + 2 * w
        self.mfe = _ConvTower(stacked, w)
        self.mam = _AttentionTower(stacked, w)
        # spectral attention convs (ConvBNReLU_0, _1), then the classifier's
        # five VALID convs (ConvBNReLU_2 to _6), flax's numbering
        ins = (256, 256, w, 256, 256, 256, 256)
        outs = (256, w, 256, 256, 256, 256, 1024)
        for i, (n, f) in enumerate(zip(ins, outs)):
            setattr(self, "ConvBNReLU_{}".format(i),
                    ConvBNReLU(n, f, 3, padding=1 if i < 2 else 0))
        self.Conv_0 = Conv(1024, n_classes, 1, init="kaiming_out")

    def forward(self, hsi, lidar):
        fhs = self.hfe(hsi)
        sa = self._ResUnitPooled_1(self._ResUnitPooled_0(hsi))
        sa = self.ConvBNReLU_1(self.ConvBNReLU_0(sa))
        sa = adaptive_avg_pool(max_pool_2x2(sa))[:, None, None, :]
        ms = sa * fhs
        mt = self.spatial_am(lidar) * fhs
        stacked = torch.cat([hsi, lidar, ms, mt], dim=-1)
        x = self.mfe(stacked) * self.mam(stacked)
        for i in range(2, 7):
            x = getattr(self, "ConvBNReLU_{}".format(i))(x)
        return self.Conv_0(x)[:, 0, 0]
