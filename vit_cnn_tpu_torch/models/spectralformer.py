"""SpectralFormer in PyTorch (port of :mod:`vit_cnn_tpu.models.
spectralformer`, ref: model/compare_method/spectralformer.py:111-156).

Patch 1: each of the C1 HSI bands and C2 LiDAR bands of the center pixel
is one token (patch_dim 1) embedded to ``dim``; a CLS token and learned
positions feed a 'ViT'-wired backbone (146 tokens at Houston2013 width,
kernel K8 in every layer); the CLS token goes through LayerNorm (eps
1e-5) and a Dense head. Dropout (rate ``dropout`` in the backbone,
``emb_dropout`` after the positions) acts in train mode.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn.layers import Dense, LayerNorm
from ..nn.noise import Dropout
from ..nn.transformer import ViTBackbone
from .base import squeeze_pixel


class SpectralFormer(nn.Module):
    def __init__(self, num_patches: int, n_classes: int, dim: int = 64,
                 depth: int = 5, heads: int = 4, dim_head: int = 16,
                 mlp_dim: int = 8, dropout: float = 0.1,
                 emb_dropout: float = 0.1, mode: str = "ViT"):
        super().__init__()
        self.patch_to_embedding = Dense(1, dim)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embedding = nn.Parameter(torch.empty(1, num_patches + 1, dim))
        self.emb_drop = Dropout(emb_dropout)
        self.transformer = ViTBackbone(dim, depth, heads, dim_head, mlp_dim,
                                       dropout, mode,
                                       num_tokens=num_patches + 1)
        self.head_norm = LayerNorm(dim, eps=1e-5)
        self.head = Dense(dim, n_classes)

    def reset_parameters(self, g: torch.Generator):
        for p in (self.cls_token, self.pos_embedding):
            nn.init.normal_(p, 0.0, 1.0, generator=g)

    def forward(self, hsi, lidar):
        x = torch.cat([squeeze_pixel(hsi)[..., None],
                       squeeze_pixel(lidar)[..., None]], dim=1)
        x = self.patch_to_embedding(x)                    # (B, N, dim)
        b, n, d = x.shape
        x = torch.cat([self.cls_token.expand(b, 1, d), x], dim=1)
        x = self.emb_drop(x + self.pos_embedding[:, :n + 1])
        x = self.transformer(x)
        return self.head(self.head_norm(x[:, 0]))
