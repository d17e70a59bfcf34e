"""The MDL-RS fusion CNNs in PyTorch (port of
:mod:`vit_cnn_tpu.models.mdl_hong`, ref: model/compare_method/
DML_Hong.py:9-324): early, middle, late and cross fusion.

* stem per branch: 3x3 conv (+BN+ReLU) -> 1x1 conv -> SAME max pool ->
  3x3 conv -> 1x1 conv -> SAME max pool (7x7 -> 4x4 -> 3x3),
* joint head: two 1x1 convs -> average pool -> Dense to the classes,
* Cross_fusion_CNN applies its stage-4 convs ``conv4_a`` and ``conv4_b``
  to both modalities (one parameter set, two call sites each) and
  returns three logit sets of one shared head, for ``cross_fusion_loss``.

Submodule names are flax's (``_Stem_0``, ``ConvBNReLU_0``, ``Dense_0``),
so convert.py maps the JAX variables by name.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn.layers import ConvBNReLU, Dense, adaptive_avg_pool, max_pool_same

_N1 = 16
_FILTERS = (_N1, _N1 * 2, _N1 * 4, _N1 * 8, _N1 * 16)


class _Stem(nn.Module):
    """conv1 (3x3) conv2 (1x1) pool conv3 (3x3) [conv4 (1x1) pool]."""

    def __init__(self, in_features: int, upto4: bool = True):
        super().__init__()
        f = _FILTERS
        self.upto4 = upto4
        self.ConvBNReLU_0 = ConvBNReLU(in_features, f[0], 3, padding=1)
        self.ConvBNReLU_1 = ConvBNReLU(f[0], f[1], 1, padding=0)
        self.ConvBNReLU_2 = ConvBNReLU(f[1], f[2], 3, padding=1)
        if upto4:
            self.ConvBNReLU_3 = ConvBNReLU(f[2], f[3], 1, padding=0)

    def forward(self, x):
        x = max_pool_same(self.ConvBNReLU_1(self.ConvBNReLU_0(x)))
        x = self.ConvBNReLU_2(x)
        if self.upto4:
            x = max_pool_same(self.ConvBNReLU_3(x))
        return x


class _JointHead(nn.Module):
    """conv5 (1x1) + conv6 (1x1) -> average pool -> Dense."""

    def __init__(self, in_features: int, n_classes: int):
        super().__init__()
        f = _FILTERS
        self.ConvBNReLU_0 = ConvBNReLU(in_features, f[3], 1, padding=0)
        self.ConvBNReLU_1 = ConvBNReLU(f[3], f[2], 1, padding=0)
        self.Dense_0 = Dense(f[2], n_classes, init="kaiming_out")

    def forward(self, x):
        x = self.ConvBNReLU_1(self.ConvBNReLU_0(x))
        return self.Dense_0(adaptive_avg_pool(x))


class Early_fusion_CNN(nn.Module):
    """Input-level concat (ref: DML_Hong.py:9-63)."""

    def __init__(self, n_bands1: int, n_bands2: int, n_classes: int):
        super().__init__()
        self._Stem_0 = _Stem(n_bands1 + n_bands2)
        self._JointHead_0 = _JointHead(_FILTERS[3], n_classes)

    def forward(self, hsi, lidar):
        x = self._Stem_0(torch.cat([hsi, lidar], dim=-1))
        return self._JointHead_0(x)


class Middle_fusion_CNN(nn.Module):
    """Feature-level concat after both stems (ref: DML_Hong.py:65-140)."""

    def __init__(self, n_bands1: int, n_bands2: int, n_classes: int):
        super().__init__()
        self.stem_a = _Stem(n_bands1)
        self.stem_b = _Stem(n_bands2)
        self._JointHead_0 = _JointHead(2 * _FILTERS[3], n_classes)

    def forward(self, hsi, lidar):
        x = torch.cat([self.stem_a(hsi), self.stem_b(lidar)], dim=-1)
        return self._JointHead_0(x)


class Late_fusion_CNN(nn.Module):
    """Logit-level concat after two full towers (ref: DML_Hong.py:
    142-224)."""

    def __init__(self, n_bands1: int, n_bands2: int, n_classes: int):
        super().__init__()
        f = _FILTERS
        for side, n in (("a", n_bands1), ("b", n_bands2)):
            setattr(self, "stem_" + side, _Stem(n))
            setattr(self, "c5_" + side, ConvBNReLU(f[3], f[3], 1, padding=0))
            setattr(self, "c6_" + side, ConvBNReLU(f[3], f[2], 1, padding=0))
        self.Dense_0 = Dense(2 * f[2], n_classes, init="kaiming_out")

    def _tower(self, x, side: str):
        x = getattr(self, "stem_" + side)(x)
        x = getattr(self, "c6_" + side)(getattr(self, "c5_" + side)(x))
        return adaptive_avg_pool(x)

    def forward(self, hsi, lidar):
        x = torch.cat([self._tower(hsi, "a"), self._tower(lidar, "b")],
                      dim=-1)
        return self.Dense_0(x)


class Cross_fusion_CNN(nn.Module):
    """Weight-shared cross-modal paths, three logit sets (ref:
    DML_Hong.py:226-323). Each stage-4 conv serves both modalities: in
    train mode its BatchNorm statistics update twice a step, in call
    order, as flax's do."""

    def __init__(self, n_bands1: int, n_bands2: int, n_classes: int):
        super().__init__()
        f = _FILTERS
        self.stem_a = _Stem(n_bands1, upto4=False)
        self.stem_b = _Stem(n_bands2, upto4=False)
        self.conv4_a = ConvBNReLU(f[2], f[3], 1, padding=0)
        self.conv4_b = ConvBNReLU(f[2], f[3], 1, padding=0)
        self.joint_head = _JointHead(2 * f[3], n_classes)

    def forward(self, hsi, lidar):
        x1, x2 = self.stem_a(hsi), self.stem_b(lidar)
        # the reference's order (ref: :292-299)
        x11 = max_pool_same(self.conv4_a(x1))
        x22 = max_pool_same(self.conv4_b(x2))
        x12 = max_pool_same(self.conv4_b(x1))
        x21 = max_pool_same(self.conv4_a(x2))
        j1 = torch.cat([x11 + x21, x22 + x12], dim=-1)
        j2 = torch.cat([x11, x12], dim=-1)
        j3 = torch.cat([x22, x21], dim=-1)
        head = self.joint_head
        return head(j1), head(j2), head(j3)
