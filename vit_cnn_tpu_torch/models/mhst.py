"""MHST in PyTorch (port of :mod:`vit_cnn_tpu.models.mhst`, ref:
model/compare_method/MHST/).

* HSI encoder: a strided 3-D conv stem over the bands (kernel (11, 3, 3),
  stride (3, 1, 1)), a 1/3/5/11 band inception, a 3x3x3 conv, the
  (channel, depth) flatten in channel-major order, a PyConv4 pyramid, a
  1x1 conv and a 2x2 max pool; LiDAR encoder: two PyConv4 stages, a 1x1
  conv and the pool. Learned scalar mixing (weight_hsi, weight_lidar).
* Tokens: each of the 64 channels' spatial vector embedded to P^2
  positions, CLS token, learned positions (position 0 added to every
  token, as the reference does).
* en_transformer: a 'ViT' backbone, 4 heads of 16 (kernel K8).
* hsp_block{i}: head-select pooling blocks. Each selects heads from the
  CLS token (:func:`gumbel_sigmoid`, straight-through), pools q, k and v
  with one 3x3 depthwise conv shared by the heads, and runs the group
  LayerNorm, 16 heads of 4 and the +q residual as kernel K9; the
  selection masks the attention output and fc1's input, and in train mode
  q, k and v too. In train mode with ``attn_drop`` > 0 the attention is
  the unfused formula with dropout on its probabilities, as in the JAX
  package.
* Dual head: softmax ViT head and softmax PyConv CNN head blended by
  learned scalars: the model returns blended probabilities.

Every LayerNorm here uses eps 1e-5; GELU is the tanh form. Dropout
(flax's, :mod:`..nn.noise`) acts in train mode: after the positions
(``emb_dropout``), in en_transformer (``dropout``), after each pooled
block's proj, fc1 and fc2 (``attnproj_mlp_drop``) and on its attention
probabilities (``attn_drop``). Under the bf16 policy the Gumbel uniforms
are float32, so the head selection, and from it the pooled blocks,
compute in float32, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn import noise
from ..nn.layers import (BatchNorm, Conv, Dense, LayerNorm, _lecun_normal_,
                         gelu, max_pool_2x2)
from ..nn.noise import Dropout
from ..nn.pyconv import PyConv
from ..nn.transformer import ViTBackbone
from ..ops.attention import ln_groups_reference, pooled_heads_attention_auto


def gumbel_sigmoid(logits, tau: float = 5.0, training: bool = False):
    """Two-sample Gumbel sigmoid with the straight-through hard threshold
    at 0.5 (ref: HSPT.py:7-30). Training: g = -log(-log(u) + 1e-10) for
    two uniforms u in [1e-10, 1) (float32, or float64 for float64 logits,
    so bf16 logits promote), y_soft = sigmoid((logits + g1 - g2) / tau);
    eval: y_soft = sigmoid(logits). Returns y_hard - y_soft + y_soft with
    y_hard in the logits' dtype and the gradient of y_soft."""
    if training:
        f = torch.promote_types(logits.dtype, torch.float32)
        g1, g2 = (-torch.log(-torch.log(noise.uniform(
            logits.shape, logits.device, 1e-10, 1.0).to(f)) + 1e-10)
            for _ in range(2))
        y_soft = torch.sigmoid((logits + g1 - g2) / tau)
    else:
        y_soft = torch.sigmoid(logits)
    y_hard = (y_soft > 0.5).to(logits.dtype)
    return y_hard - y_soft.detach() + y_soft


class _HSIEncoder(nn.Module):
    def __init__(self, n_bands: int, out_channels_3d: int = 16,
                 out_channels_2d: int = 64):
        super().__init__()
        oc, oc2 = out_channels_3d, out_channels_2d
        self.conv1 = Conv(1, oc, (11, 3, 3), strides=(3, 1, 1),
                          padding=(5, 1, 1))
        self.bn1 = BatchNorm(oc)
        for i, k in enumerate((1, 3, 5, 11)):
            setattr(self, "conv2_{}".format(i + 1),
                    Conv(oc, oc // 4, (k, 1, 1), padding=(k // 2, 0, 0)))
        self.bn2 = BatchNorm(oc)
        self.conv3 = Conv(oc, oc, (3, 3, 3), padding=1)
        self.bn3 = BatchNorm(oc)
        depth = (n_bands - 1) // 3 + 1
        self.conv4 = PyConv(oc * depth, oc2, (3, 5, 7, 9), (4, 4, 4, 4),
                            (1, 2, 4, 8))
        self.bn4 = BatchNorm(oc2)
        self.conv5 = Conv(oc2, oc2, 1)
        self.bn5 = BatchNorm(oc2)

    def forward(self, hsi):
        b, p, _, _ = hsi.shape
        x = hsi.permute(0, 3, 1, 2)[..., None]          # NDHWC, bands = D
        x = F.relu(self.bn1(self.conv1(x)))
        x = torch.cat([getattr(self, "conv2_{}".format(i))(x)
                       for i in range(1, 5)], dim=-1)
        x = F.relu(self.bn2(x))
        x = F.relu(self.bn3(self.conv3(x)))
        # (oc, depth) channel-major, the reference's 'b c h w y -> b (c h)
        # w y' order: conv4's groups partition these channels
        oc, d = x.shape[-1], x.shape[1]
        x = x.permute(0, 2, 3, 4, 1).reshape(b, p, p, oc * d)
        x = F.relu(self.bn4(self.conv4(x)))
        x = F.relu(self.bn5(self.conv5(x)))
        return max_pool_2x2(x)


class _LiDAREncoder(nn.Module):
    def __init__(self, n_bands: int, out_channels: int = 64):
        super().__init__()
        self.conv1 = PyConv(n_bands, 32, (3, 5, 7, 9), (4, 4, 4, 4),
                            (1, 1, 1, 1))
        self.bn1 = BatchNorm(32)
        self.conv2 = PyConv(32, out_channels, (3, 5, 7, 9), (4, 4, 4, 4),
                            (1, 1, 1, 1))
        self.bn2 = BatchNorm(out_channels)
        self.conv3 = Conv(out_channels, out_channels, 1)
        self.bn3 = BatchNorm(out_channels)

    def forward(self, lidar):
        x = F.relu(self.bn1(self.conv1(lidar)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        return max_pool_2x2(x)


class _DWPoolKernel(nn.Module):
    """The 3x3 depthwise pool filters shared by all heads: weight
    (hd, 1, 3, 3), the flax (3, 3, 1, hd) kernel. At use it is tiled over
    the heads head-major, as ``jnp.tile(kernel, (1, 1, 1, h))``."""

    flax_kernel = "conv"

    def __init__(self, hd: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(hd, 1, 3, 3))

    def reset_parameters(self, g: torch.Generator):
        _lecun_normal_(self.weight, 9, g)


class _PoolAttention(nn.Module):
    """MViT pooled attention with per-sample head masking (ref:
    HSPT.py:142-290), head-last throughout. In eval the q / k / v head
    masks are dropped: every op between them and the output mask is
    per-head, so masking the output alone gives the same result. Training
    keeps them: the straight-through head selection takes its gradient
    through every mask."""

    def __init__(self, dim: int, num_heads: int, hw_shape: Tuple[int, int],
                 qkv_bias: bool = False, attn_drop: float = 0.0,
                 proj_drop: float = 0.0):
        super().__init__()
        self.num_heads, self.hw_shape = num_heads, tuple(hw_shape)
        self.attn_drop = Dropout(attn_drop)
        self.proj_drop = Dropout(proj_drop)
        hd = dim // num_heads
        self.query = Dense(dim, dim, use_bias=qkv_bias)
        self.key = Dense(dim, dim, use_bias=qkv_bias)
        self.value = Dense(dim, dim, use_bias=qkv_bias)
        for name in ("pool_q", "pool_k", "pool_v"):
            setattr(self, name, _DWPoolKernel(hd))
            setattr(self, name + "_norm", LayerNorm(hd, eps=1e-5))
        self.proj = Dense(dim, dim)

    def _pool(self, t, name):
        b, n, c = t.shape
        hh, ww = self.hw_shape
        w = getattr(self, name).weight.repeat(self.num_heads, 1, 1, 1)
        rest = t[:, 1:].reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        r = F.conv2d(rest, w.to(t.dtype), None, 1, 1, 1, c)
        r = r.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        norm = getattr(self, name + "_norm")
        return torch.cat([t[:, :1], r], dim=1), (norm.weight, norm.bias)

    def forward(self, x, width_select):
        b, n, c = x.shape
        h = self.num_heads
        hd = c // h
        masked = ((lambda t: t * width_select) if self.training
                  else (lambda t: t))
        q, ln_q = self._pool(masked(self.query(x)), "pool_q")
        k, ln_k = self._pool(masked(self.key(x)), "pool_k")
        v, ln_v = self._pool(masked(self.value(x)), "pool_v")
        if self.training and self.attn_drop.rate > 0:
            # the reference drops attention probabilities (ref:
            # HSPT.py:263): the unfused formula, in q's dtype
            hv = lambda t, ln: ln_groups_reference(t, *ln, hd).reshape(
                b, n, h, hd)
            q, k, v = hv(q, ln_q), hv(k, ln_k), hv(v, ln_v)
            attn = torch.einsum("bihd,bjhd->bhij", q, k) * hd ** -0.5
            attn = self.attn_drop(torch.softmax(attn, dim=-1))
            out = torch.einsum("bhij,bjhd->bihd", attn, v)
            out = torch.cat([out[:, :1], out[:, 1:] + q[:, 1:]], dim=1)
            out = out.reshape(b, n, c)
        else:
            out = pooled_heads_attention_auto(q, k, v, ln_q, ln_k, ln_v, h,
                                              hd ** -0.5)
        return self.proj_drop(self.proj(out * width_select))


class _StepPoolBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, hw_shape: Tuple[int, int],
                 head_tau: float = 5.0, qkv_bias: bool = False,
                 mlp_ratio: float = 4.0, drop: float = 0.0,
                 attn_drop: float = 0.0):
        super().__init__()
        self.dim, self.num_heads, self.head_tau = dim, num_heads, head_tau
        self.head_select = Dense(dim, num_heads)
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = _PoolAttention(dim, num_heads, hw_shape, qkv_bias,
                                   attn_drop, drop)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        hidden = int(dim * mlp_ratio)
        self.fc1 = Dense(dim, hidden)
        self.fc2 = Dense(hidden, dim)
        self.drop = Dropout(drop)

    def forward(self, x):
        head_select = gumbel_sigmoid(self.head_select(x[:, 0]),
                                     self.head_tau, self.training)  # (B, H)
        hd = self.dim // self.num_heads
        width_select = head_select.repeat_interleave(hd, dim=-1)[:, None]
        x = x + self.attn(self.norm1(x), width_select)
        z = self.drop(gelu(self.fc1(self.norm2(x) * width_select)))
        return x + self.drop(self.fc2(z))


class MHST(nn.Module):
    def __init__(self, n_bands1: int, n_bands2: int, patch_size: int,
                 n_classes: int, encoder_embed_dim: int = 64,
                 en_depth: int = 5, en_heads: int = 4, dim_head: int = 16,
                 mlp_dim: int = 8, dropout: float = 0.1,
                 emb_dropout: float = 0.1, coefficient_hsi: float = 0.6,
                 coefficient_vit: float = 0.7, hsp_vit_depth: int = 8,
                 hsp_vit_num_heads: int = 16, head_tau: float = 5.0,
                 vit_qkv_bias: bool = True, mlp_ratio: float = 4.0,
                 attnproj_mlp_drop: float = 0.1, attn_drop: float = 0.1):
        super().__init__()
        p, dim = patch_size, encoder_embed_dim
        self.coefficients = (coefficient_hsi, coefficient_vit)
        self.hsp_vit_depth = hsp_vit_depth
        self.hsi_encoder = _HSIEncoder(n_bands1, 16, dim)
        self.lidar_encoder = _LiDAREncoder(n_bands2, dim)
        self.weight_hsi = nn.Parameter(torch.empty(1))
        self.weight_lidar = nn.Parameter(torch.empty(1))
        self.encoder_embedding = Dense((p // 2) ** 2, p * p)
        self.encoder_pos_embed = nn.Parameter(torch.empty(1, p * p + 1, dim))
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.emb_drop = Dropout(emb_dropout)
        self.en_transformer = ViTBackbone(dim, en_depth, en_heads, dim_head,
                                          mlp_dim, dropout)
        for i in range(hsp_vit_depth):
            setattr(self, "hsp_block{}".format(i),
                    _StepPoolBlock(dim, hsp_vit_num_heads, (p, p), head_tau,
                                   vit_qkv_bias, mlp_ratio,
                                   attnproj_mlp_drop, attn_drop))
        self.hsp_norm = LayerNorm(dim, eps=1e-5)
        self.head_norm = LayerNorm(dim, eps=1e-5)
        self.head = Dense(dim, n_classes)
        self.cls_conv1 = PyConv(dim, 32, (3, 5), (2, 2), (2, 2))
        self.cls_bn1 = BatchNorm(32)
        self.cls_conv2 = Dense(32, n_classes)
        self.vit_cls_coefficient = nn.Parameter(torch.empty(1))
        self.cnn_cls_coefficient = nn.Parameter(torch.empty(1))

    def reset_parameters(self, g: torch.Generator):
        hsi, vit = self.coefficients
        for p, v in ((self.weight_hsi, hsi), (self.weight_lidar, 1 - hsi),
                     (self.vit_cls_coefficient, vit),
                     (self.cnn_cls_coefficient, 1 - vit)):
            nn.init.constant_(p, v)
        for p in (self.encoder_pos_embed, self.cls_token):
            nn.init.normal_(p, 0.0, 1.0, generator=g)

    def forward(self, hsi, lidar):
        b, p, _, _ = hsi.shape
        x = (self.weight_hsi * self.hsi_encoder(hsi)
             + self.weight_lidar * self.lidar_encoder(lidar))
        dim = x.shape[-1]
        half = p // 2
        x = x.reshape(b, half * half, dim).transpose(1, 2)   # (B, 64, hh)
        x_cnn = self.encoder_embedding(x)                    # (B, 64, P^2)
        pos = self.encoder_pos_embed
        t = x_cnn.transpose(1, 2) + pos[:, 1:]
        t = torch.cat([self.cls_token.expand(b, 1, dim), t], dim=1)
        t = self.en_transformer(self.emb_drop(t + pos[:, :1]))
        for i in range(self.hsp_vit_depth):
            t = getattr(self, "hsp_block{}".format(i))(t)
        t = self.hsp_norm(t)
        vit_probs = torch.softmax(self.head(self.head_norm(t[:, 0])), dim=-1)

        img = x_cnn.reshape(b, dim, p, p).permute(0, 2, 3, 1)
        y = F.relu(self.cls_bn1(self.cls_conv1(img))).mean(dim=(1, 2))
        cnn_probs = torch.softmax(self.cls_conv2(y), dim=-1)
        return (vit_probs * self.vit_cls_coefficient
                + cnn_probs * self.cnn_cls_coefficient)
