"""S2EFT in PyTorch (port of :mod:`vit_cnn_tpu.models.s2eft`, ref:
model/compare_method/S2EFT.py:110-162 with the JAX package's repairs).

Tokens are the C HSI bands; each carries the patch pixels of
``near_band`` adjacent bands (wrap-around), so patch_dim = P^2 near_band.
A channel-attention gate (mean / max over a token's features, a 7-tap
1-D conv across the bands, sigmoid) keeps a token only where the gate is
>= 0.4; the hard gate passes no gradient. A CLS token and the first n + 1
of num_patches + 2 learned positions feed a 'CAF'-wired backbone (145
tokens at Houston2013 width, kernel K8 in every layer); the head is
LayerNorm with flax's default eps 1e-6 and a Dense layer. Dropout (rate
``dropout`` in the backbone, ``emb_dropout`` after the positions) acts in
train mode. The LiDAR input is accepted and ignored.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..nn.layers import Conv, Dense, LayerNorm
from ..nn.noise import Dropout
from ..nn.transformer import ViTBackbone


class S2EFT(nn.Module):
    def __init__(self, num_patches: int, patch_size: int, n_classes: int,
                 dim: int = 64, depth: int = 5, heads: int = 4,
                 dim_head: int = 16, mlp_dim: int = 8, dropout: float = 0.1,
                 emb_dropout: float = 0.1, mode: str = "CAF",
                 near_band: int = 3):
        super().__init__()
        self.near_band = near_band
        self.gate_conv = Conv(2, 1, (7,), padding=3)
        self.patch_to_embedding = Dense(patch_size ** 2 * near_band, dim)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embedding = nn.Parameter(torch.empty(1, num_patches + 2, dim))
        self.emb_drop = Dropout(emb_dropout)
        self.transformer = ViTBackbone(dim, depth, heads, dim_head, mlp_dim,
                                       dropout, mode,
                                       num_tokens=num_patches + 1)
        self.head_norm = LayerNorm(dim)
        self.head = Dense(dim, n_classes)

    def reset_parameters(self, g: torch.Generator):
        for p in (self.cls_token, self.pos_embedding):
            nn.init.normal_(p, 0.0, 1.0, generator=g)

    def forward(self, hsi, lidar):
        b, p, _, c = hsi.shape
        x = hsi.reshape(b, p * p, c).transpose(1, 2)       # (B, C, P*P)
        x = torch.cat([torch.roll(x, -i, dims=1)
                       for i in range(self.near_band)], dim=-1)
        g = torch.cat([x.mean(dim=-1, keepdim=True),
                       x.amax(dim=-1, keepdim=True)], dim=-1)  # (B, C, 2)
        g = torch.sigmoid(self.gate_conv(g))               # (B, C, 1)
        x = x * (g >= 0.4).to(x.dtype).detach()
        x = self.patch_to_embedding(x)
        n, d = x.shape[1], x.shape[2]
        x = torch.cat([self.cls_token.expand(b, 1, d), x], dim=1)
        x = self.emb_drop(x + self.pos_embedding[:, :n + 1])
        x = self.transformer(x)
        return self.head(self.head_norm(x[:, 0]))
