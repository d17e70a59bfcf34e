"""EndNet in PyTorch (port of :mod:`vit_cnn_tpu.models.endnet`, ref:
model/compare_method/EndNet.py:9-90): dual MLP encoder-decoder fusion on
single pixels (patch 1).

* per-modality 4-layer MLP encoders 16 -> 32 -> 64 -> 128, each layer
  Dense + BatchNorm + ReLU,
* concat -> joint Dense (256 -> 128) + BN + ReLU, head Dense 128 -> 64
  (+ BN + ReLU) -> classes,
* two 4-layer sigmoid MLP decoders reconstructing both inputs from the
  joint code,
* returns (logits, recon1, recon2, input1, input2) for
  :func:`vit_cnn_tpu_torch.train.losses.endnet_loss`; serving keeps the
  logits.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.layers import BatchNorm, Dense
from .base import squeeze_pixel


class _MLPEncoder(nn.Module):
    def __init__(self, in_features: int, filters):
        super().__init__()
        self.n = len(filters)
        for i, f in enumerate(filters):
            setattr(self, "Dense_{}".format(i), Dense(in_features, f))
            setattr(self, "BatchNorm_{}".format(i), BatchNorm(f))
            in_features = f

    def forward(self, x):
        for i in range(self.n):
            x = getattr(self, "Dense_{}".format(i))(x)
            x = F.relu(getattr(self, "BatchNorm_{}".format(i))(x))
        return x


class _MLPDecoder(nn.Module):
    def __init__(self, in_features: int, filters):
        super().__init__()
        self.n = len(filters)
        for i, f in enumerate(filters):
            setattr(self, "Dense_{}".format(i), Dense(in_features, f))
            in_features = f

    def forward(self, x):
        for i in range(self.n):
            x = torch.sigmoid(getattr(self, "Dense_{}".format(i))(x))
        return x


class EndNet(nn.Module):
    def __init__(self, n_bands1: int, n_bands2: int, n_classes: int,
                 width: int = 16):
        super().__init__()
        f = (width, width * 2, width * 4, width * 8)
        self.encoder_a = _MLPEncoder(n_bands1, f)
        self.encoder_b = _MLPEncoder(n_bands2, f)
        self.joint_fc5 = Dense(2 * f[3], f[3])
        self.joint_bn5 = BatchNorm(f[3])
        self.joint_fc6 = Dense(f[3], f[2])
        self.joint_bn6 = BatchNorm(f[2])
        self.head = Dense(f[2], n_classes)
        self.decoder_a = _MLPDecoder(f[3], (f[2], f[1], f[0], n_bands1))
        self.decoder_b = _MLPDecoder(f[3], (f[2], f[1], f[0], n_bands2))

    def forward(self, hsi, lidar):
        x1, x2 = squeeze_pixel(hsi), squeeze_pixel(lidar)
        joint = torch.cat([self.encoder_a(x1), self.encoder_b(x2)], dim=1)
        joint = F.relu(self.joint_bn5(self.joint_fc5(joint)))
        out = F.relu(self.joint_bn6(self.joint_fc6(joint)))
        logits = self.head(out)
        return (logits, self.decoder_a(joint), self.decoder_b(joint), x1,
                x2)
