"""HCTnet in PyTorch (port of :mod:`vit_cnn_tpu.models.hctnet`, ref:
model/compare_method/HCTnet.py:224-367): hierarchical cross-token
transformer, at 30 PCA components of the HSI by the registry's default.

* HSI stem: 3-D conv 1 -> 8, 3x3x3 VALID (kaiming fan_in) + BN + ReLU;
  the (8, bands - 2) channels flattened 8-major into a VALID 3x3 conv ->
  64 + BN + ReLU (the working 8 (bands - 2) input width, QUIRKS.md
  "Repaired"); LiDAR stem: VALID 3x3 conv -> 64 + BN + ReLU.
* Learned tokenization (:func:`.mft.tokenize`) with one ``token_wA`` /
  ``token_wV`` pair shared by both modalities.
* A zero-initialised CLS token and positions (std 0.02) shared by both.
* Fusion encoder: a transformer per modality (attention scaled by
  dim^-0.5, qkv bias), then cross-token attention exchanging the CLS
  tokens (q from the CLS, k and v from the CLS and the other modality's
  patch tokens, dim_head 64), dropout on its probabilities.
* One LayerNorm + Dense head applied to both CLS tokens, summed.

LayerNorm eps 1e-5 throughout; dropout 0.1 (flax's, in train mode) after
the positions (drawn for the HSI tokens, then the LiDAR's), after each
attention's output projection, on the cross attention's probabilities
and after both MLP layers; GELU is the tanh form.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.layers import (BatchNorm, Conv, Dense, LayerNorm, gelu,
                         init_weight_)
from ..nn.noise import Dropout
from .mft import tokenize


def _heads(t, h):
    b, n, c = t.shape
    return t.reshape(b, n, h, c // h).transpose(1, 2)


def _merge(t):
    b, h, n, d = t.shape
    return t.transpose(1, 2).reshape(b, n, h * d)


class _Attention(nn.Module):
    """Self-attention scaled by dim^-0.5 (ref: HCTnet.py:56-94)."""

    def __init__(self, dim: int, heads: int = 8, dropout: float = 0.1):
        super().__init__()
        self.heads, self.dim = heads, dim
        self.to_qkv = Dense(dim, dim * 3, init="kaiming_in")
        self.nn1 = Dense(dim, dim, init="kaiming_in")
        self.drop = Dropout(dropout)

    def forward(self, x):
        q, k, v = (_heads(t, self.heads)
                   for t in self.to_qkv(x).chunk(3, dim=-1))
        attn = torch.softmax(q @ k.transpose(-1, -2) * self.dim ** -0.5,
                             dim=-1)
        return self.drop(self.nn1(_merge(attn @ v)))


class _MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, dropout: float = 0.1):
        super().__init__()
        self.Dense_0 = Dense(dim, hidden, init="kaiming_in")
        self.Dense_1 = Dense(hidden, dim, init="kaiming_in")
        self.drop = Dropout(dropout)

    def forward(self, x):
        x = self.drop(gelu(self.Dense_0(x)))
        return self.drop(self.Dense_1(x))


class _Transformer(nn.Module):
    """One pre-norm layer (the fusion encoder's per-modality depth 1)."""

    def __init__(self, dim: int, heads: int, mlp_dim: int,
                 dropout: float = 0.1):
        super().__init__()
        self.attn_norm0 = LayerNorm(dim, eps=1e-5)
        self.attn0 = _Attention(dim, heads, dropout)
        self.mlp_norm0 = LayerNorm(dim, eps=1e-5)
        self.mlp0 = _MLPBlock(dim, mlp_dim, dropout)

    def forward(self, x):
        x = x + self.attn0(self.attn_norm0(x))
        return x + self.mlp0(self.mlp_norm0(x))


class _CTAttention(nn.Module):
    """Cross-token attention: q from the CLS, k and v from the CLS and the
    context (ref: HCTnet.py:96-131)."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 dropout: float = 0.1):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Dense(dim, inner, use_bias=False)
        self.to_kv = Dense(dim, inner * 2, use_bias=False)
        self.to_out = Dense(inner, dim)
        self.attn_drop = Dropout(dropout)
        self.drop = Dropout(dropout)

    def forward(self, x, context):
        q = _heads(self.to_q(x), self.heads)
        k, v = (_heads(t, self.heads) for t in
                self.to_kv(torch.cat([x, context], dim=1)).chunk(2, dim=-1))
        attn = torch.softmax(q @ k.transpose(-1, -2)
                             * self.dim_head ** -0.5, dim=-1)
        out = _merge(self.attn_drop(attn) @ v)
        return self.drop(self.to_out(out))


class HCTnet(nn.Module):
    def __init__(self, n_bands1: int, n_bands2: int, n_classes: int,
                 num_tokens: int = 4, dim: int = 64, heads: int = 8,
                 mlp_dim: int = 8, depth: int = 1, dropout: float = 0.1,
                 emb_dropout: float = 0.1, ct_attn_dim_head: int = 64):
        super().__init__()
        self.depth, self.dim = depth, dim
        self.conv3d = Conv(1, 8, (3, 3, 3), init="kaiming_in")
        self.bn3d = BatchNorm(8)
        self.conv2d = Conv(8 * (n_bands1 - 2), 64, 3)
        self.bn2d = BatchNorm(64)
        self.conv2d_l = Conv(n_bands2, 64, 3)
        self.bn2d_l = BatchNorm(64)
        self.token_wA = nn.Parameter(torch.empty(num_tokens, dim))
        self.token_wV = nn.Parameter(torch.empty(dim, dim))
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embedding = nn.Parameter(torch.empty(1, num_tokens + 1,
                                                      dim))
        self.drop = Dropout(emb_dropout)
        for l in range(depth):
            for side in ("h", "l"):
                setattr(self, "{}_enc{}".format(side, l),
                        _Transformer(dim, heads, mlp_dim, dropout))
                setattr(self, "ct_{}_norm{}".format(side, l),
                        LayerNorm(dim, eps=1e-5))
                setattr(self, "ct_{}{}".format(side, l),
                        _CTAttention(dim, heads, ct_attn_dim_head, dropout))
        self.head_norm = LayerNorm(dim, eps=1e-5)
        self.head = Dense(dim, n_classes, init="kaiming_in")

    def reset_parameters(self, g: torch.Generator):
        init_weight_(self.token_wA, "xavier_normal", g)
        init_weight_(self.token_wV, "xavier_normal", g)
        nn.init.zeros_(self.cls_token)
        nn.init.normal_(self.pos_embedding, 0.0, 0.02, generator=g)

    def forward(self, hsi, lidar):
        b = hsi.shape[0]
        x1 = hsi.permute(0, 3, 1, 2)[..., None]        # (B, NC, P, P, 1)
        x1 = F.relu(self.bn3d(self.conv3d(x1)))        # (B, NC-2, s, s, 8)
        s = x1.shape[2]
        x1 = x1.permute(0, 2, 3, 4, 1).reshape(b, s, s, -1)   # 8-major
        x1 = F.relu(self.bn2d(self.conv2d(x1)))
        x2 = F.relu(self.bn2d_l(self.conv2d_l(lidar)))
        cls = self.cls_token.expand(b, 1, self.dim)
        x1 = torch.cat([cls, tokenize(x1.reshape(b, -1, 64), self.token_wA,
                                      self.token_wV)], dim=1)
        x2 = torch.cat([cls, tokenize(x2.reshape(b, -1, 64), self.token_wA,
                                      self.token_wV)], dim=1)
        x1 = self.drop(x1 + self.pos_embedding)
        x2 = self.drop(x2 + self.pos_embedding)
        for l in range(self.depth):
            x1 = getattr(self, "h_enc{}".format(l))(x1)
            x2 = getattr(self, "l_enc{}".format(l))(x2)
            h_cls, h_patch = x1[:, :1], x1[:, 1:]
            l_cls, l_patch = x2[:, :1], x2[:, 1:]
            h_cls = h_cls + getattr(self, "ct_h{}".format(l))(
                getattr(self, "ct_h_norm{}".format(l))(h_cls), l_patch)
            l_cls = l_cls + getattr(self, "ct_l{}".format(l))(
                getattr(self, "ct_l_norm{}".format(l))(l_cls), h_patch)
            x1 = torch.cat([h_cls, h_patch], dim=1)
            x2 = torch.cat([l_cls, l_patch], dim=1)
        return (self.head(self.head_norm(x1[:, 0]))
                + self.head(self.head_norm(x2[:, 0])))
