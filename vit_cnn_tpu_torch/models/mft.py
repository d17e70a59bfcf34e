"""MFT in PyTorch (port of :mod:`vit_cnn_tpu.models.mft`, ref:
model/compare_method/MFT.py:131-214): multimodal fusion transformer.

* HSI stem: 3-D conv 1 -> 8, kernel (9, 3, 3), VALID over the bands and
  padded 1 in space, + BN + ReLU; the (8, bands - 8) channels flattened
  8-major (the reference's order, so the grouped HetConv splits the same
  channel sets); HetConv (grouped 3x3 + pointwise 1x1, summed) -> 64 + BN
  + ReLU. The group count is 16 where 8 (bands - 8) divides by 16, else 8.
* LiDAR stem: 3x3 conv -> 64 + BN + GELU.
* Learned tokenization (:func:`tokenize`): 4 HSI tokens, 1 LiDAR token.
* 2 blocks whose attention queries only token 0 (``_MCrossAttention``:
  per-head q, k, v project head_dim -> dim); the (B, 1, C) attention
  output is added onto every token, a reference quirk kept for parity.
* LayerNorm eps 1e-6; dropout 0.1 after the positions, after the
  attention's projection and after both MLP layers (flax's, in train
  mode); the classifier on the encoded token 0.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.layers import (BatchNorm, Conv, Dense, LayerNorm, gelu,
                         init_weight_)
from ..nn.noise import Dropout


def tokenize(x, wa, wv):
    """softmax((x wa^T)^T) @ (x wv): learned token pooling (ref: MFT.py:
    189-207). x (B, N, C), wa (T, C), wv (C, C) -> (B, T, C)."""
    a = torch.softmax(torch.einsum("bnc,tc->btn", x, wa), dim=-1)
    return torch.einsum("btn,bnd->btd", a, x @ wv)


class _HetConv(nn.Module):
    """Grouped 3x3 conv + pointwise conv, summed (ref: MFT.py:15-25)."""

    def __init__(self, in_features: int, features: int, groups: int):
        super().__init__()
        self.gwc = Conv(in_features, features, 3, padding=1, groups=groups)
        self.pwc = Conv(in_features, features, 1)

    def forward(self, x):
        return self.gwc(x) + self.pwc(x)


class _MCrossAttention(nn.Module):
    """Cross attention with q from token 0; the per-head projections take
    head_dim -> dim."""

    def __init__(self, dim: int, num_heads: int = 8, proj_drop: float = 0.1):
        super().__init__()
        self.h = num_heads
        hd = dim // num_heads
        self.wq = Dense(hd, dim, use_bias=False)
        self.wk = Dense(hd, dim, use_bias=False)
        self.wv = Dense(hd, dim, use_bias=False)
        self.proj = Dense(dim * num_heads, dim)
        self.drop = Dropout(proj_drop)

    def forward(self, x):
        b, n, c = x.shape
        xh = x.reshape(b, n, self.h, c // self.h)
        q = self.wq(xh[:, :1]).transpose(1, 2)          # (B, H, 1, dim)
        k = self.wk(xh).transpose(1, 2)                 # (B, H, N, dim)
        v = self.wv(xh).transpose(1, 2)
        attn = torch.softmax(q @ k.transpose(-1, -2)
                             * (c // self.h) ** -0.5, dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(b, 1, -1)
        return self.drop(self.proj(out))                # (B, 1, dim)


class _Mlp(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.Dense_0 = Dense(dim, 512, init="xavier_uniform", bias_std=1e-6)
        self.Dense_1 = Dense(512, dim, init="xavier_uniform", bias_std=1e-6)
        self.drop = Dropout(0.1)

    def forward(self, x):
        x = self.drop(gelu(self.Dense_0(x)))
        return self.drop(self.Dense_1(x))


class _Block(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(dim, eps=1e-6)
        self._MCrossAttention_0 = _MCrossAttention(dim)
        self.LayerNorm_1 = LayerNorm(dim, eps=1e-6)
        self._Mlp_0 = _Mlp(dim)

    def forward(self, x):
        x = self._MCrossAttention_0(self.LayerNorm_0(x)) + x   # broadcast
        return self._Mlp_0(self.LayerNorm_1(x)) + x


class MFT(nn.Module):
    def __init__(self, patch_size: int, fm: int, n_bands1: int,
                 n_bands2: int, n_classes: int):
        super().__init__()
        dim = fm * 4
        self.dim = dim
        self.conv5 = Conv(1, 8, (9, 3, 3), padding=(0, 1, 1))
        self.bn5 = BatchNorm(8)
        cin = 8 * (n_bands1 - 8)
        groups = dim // 4 if cin % fm == 0 else dim // 8
        self.conv6 = _HetConv(cin, dim, groups)
        self.bn6 = BatchNorm(dim)
        self.lidar_conv = Conv(n_bands2, 64, 3, padding=1)
        self.lidar_bn = BatchNorm(64)
        self.token_wA = nn.Parameter(torch.empty(4, 64))
        self.token_wV = nn.Parameter(torch.empty(64, 64))
        self.token_wA_L = nn.Parameter(torch.empty(1, 64))
        self.token_wV_L = nn.Parameter(torch.empty(64, 64))
        self.position_embeddings = nn.Parameter(torch.empty(1, 5, dim))
        self.drop = Dropout(0.1)
        self.block0 = _Block(dim)
        self.block1 = _Block(dim)
        self.encoder_norm = LayerNorm(dim, eps=1e-6)
        self.out3 = Dense(dim, n_classes, init="xavier_uniform",
                          bias_std=1e-6)

    def reset_parameters(self, g: torch.Generator):
        for w in (self.token_wA, self.token_wV, self.token_wA_L,
                  self.token_wV_L):
            init_weight_(w, "xavier_normal", g)
        nn.init.normal_(self.position_embeddings, 0.0, 1.0, generator=g)

    def forward(self, hsi, lidar):
        b, p, _, nc = hsi.shape
        x1 = hsi.permute(0, 3, 1, 2)[..., None]        # (B, NC, P, P, 1)
        x1 = F.relu(self.bn5(self.conv5(x1)))          # (B, NC-8, P, P, 8)
        x1 = x1.permute(0, 2, 3, 4, 1).reshape(b, p, p, -1)   # 8-major
        x1 = F.relu(self.bn6(self.conv6(x1)))
        x2 = gelu(self.lidar_bn(self.lidar_conv(lidar)))
        t_hsi = tokenize(x1.reshape(b, p * p, self.dim), self.token_wA,
                         self.token_wV)
        t_lidar = tokenize(x2.reshape(b, p * p, 64), self.token_wA_L,
                           self.token_wV_L)
        x = self.drop(torch.cat([t_lidar, t_hsi], dim=1)
                      + self.position_embeddings)
        x = self.encoder_norm(self.block1(self.block0(x)))
        return self.out3(x[:, 0])
