"""The zoo's ViT backbone (port of :mod:`vit_cnn_tpu.nn.transformer`, ref:
model/compare_method/spectralformer.py:7-109 and S2EFT.py:6-108): pre-norm
residual multi-head attention and GELU feed-forward blocks, in 'ViT'
wiring or in 'CAF' wiring, where a learned (T, 2T) token-mixing matrix
merges layer l with layer l - 2 before each block from depth 2 on.

Dropout (flax's, :mod:`.noise`) follows the attention's output
projection and both feed-forward layers; it acts in train mode
(``Module.training``) and is the identity in eval mode.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..ops.attention import fused_attention_auto, fused_attention_heads_auto
from .layers import Dense, LayerNorm, _lecun_normal_, gelu
from .noise import Dropout


class ViTAttention(nn.Module):
    """Multi-head self-attention, inner width heads * dim_head. Heads
    narrower than 32 take the head-last kernel K8 on the strided q, k, v
    views of the fused projection (no copies); wider heads the folded
    K4."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 dropout: float = 0.0):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_qkv = Dense(dim, inner * 3, use_bias=False)
        self.to_out = Dense(inner, dim)
        self.drop = Dropout(dropout)

    def forward(self, x):
        b, n, _ = x.shape
        h, dh = self.heads, self.dim_head
        q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        scale = dh ** -0.5
        if dh < 32:
            hl = lambda t: t.view(b, n, h, dh)
            out = fused_attention_heads_auto(hl(q), hl(k), hl(v), scale)
        else:
            hf = lambda t: t.reshape(b, n, h, dh).transpose(1, 2).contiguous()
            out = fused_attention_auto(hf(q), hf(k), hf(v), scale)
            out = out.transpose(1, 2)
        return self.drop(self.to_out(out.reshape(b, n, h * dh)))


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0):
        super().__init__()
        self.Dense_0 = Dense(dim, hidden_dim)
        self.Dense_1 = Dense(hidden_dim, dim)
        self.drop = Dropout(dropout)

    def forward(self, x):
        x = self.drop(gelu(self.Dense_0(x)))
        return self.drop(self.Dense_1(x))


class ViTBackbone(nn.Module):
    """depth x (pre-norm attention + pre-norm feed-forward), LayerNorm eps
    1e-5. 'CAF' needs ``num_tokens`` for its skipcat{l} (T, 2T) matrices
    and skipcat{l}_bias (T,) vectors."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 mlp_dim: int, dropout: float = 0.0, mode: str = "ViT",
                 num_tokens: Optional[int] = None):
        super().__init__()
        if mode not in ("ViT", "CAF"):
            raise ValueError("mode must be 'ViT' or 'CAF', got {!r}".format(
                mode))
        if mode == "CAF" and num_tokens is None:
            raise ValueError("'CAF' wiring needs num_tokens")
        self.depth, self.mode = depth, mode
        for l in range(depth):
            setattr(self, "attn_norm{}".format(l), LayerNorm(dim, eps=1e-5))
            setattr(self, "attn{}".format(l), ViTAttention(dim, heads,
                                                           dim_head, dropout))
            setattr(self, "ff_norm{}".format(l), LayerNorm(dim, eps=1e-5))
            setattr(self, "ff{}".format(l), FeedForward(dim, mlp_dim,
                                                        dropout))
        if mode == "CAF":
            t = num_tokens
            for l in range(depth - 2):
                setattr(self, "skipcat{}".format(l),
                        nn.Parameter(torch.empty(t, 2 * t)))
                setattr(self, "skipcat{}_bias".format(l),
                        nn.Parameter(torch.empty(t)))

    def reset_parameters(self, g: torch.Generator):
        for l in range(self.depth - 2 if self.mode == "CAF" else 0):
            w = getattr(self, "skipcat{}".format(l))
            _lecun_normal_(w, w.shape[0], g)
            nn.init.zeros_(getattr(self, "skipcat{}_bias".format(l)))

    def forward(self, x):
        outputs = []
        for l in range(self.depth):
            if self.mode == "CAF":
                outputs.append(x)
                if l > 1:
                    # (B, T, D, 2) -> (B, D, 2T), token-major, the 2 source
                    # layers innermost; mixed over tokens, shared over D
                    pair = torch.stack([x, outputs[l - 2]], dim=-1)
                    b, t, d, _ = pair.shape
                    flat = pair.transpose(1, 2).reshape(b, d, 2 * t)
                    w = getattr(self, "skipcat{}".format(l - 2))
                    bias = getattr(self, "skipcat{}_bias".format(l - 2))
                    x = (torch.einsum("bdi,ti->bdt", flat, w)
                         + bias).transpose(1, 2)
            attn = getattr(self, "attn{}".format(l))
            x = x + attn(getattr(self, "attn_norm{}".format(l))(x))
            ff = getattr(self, "ff{}".format(l))
            x = x + ff(getattr(self, "ff_norm{}".format(l))(x))
        return x
