"""The multi-directional vision-Mamba layer and backbone.

Port of :mod:`vit_cnn_tpu.nn.mamba` for the static-ordering path types
(the '{L}_2+8' sets the flagship runs, and the other orderings without a
random or per-sample stream). The layer is built the way the JAX
lane-major path is (``MultiDirMambaLayer``, vit_cnn_tpu/nn/mamba.py
lane branch):

  in_proj -> (u, gate); u to (L, d, B)
  dir_conv_silu (K2): every base order's gather + causal conv + SiLU, and
      the anti-causal twin for orders whose exact reverse is a direction
  x_proj / dt_proj in that layout -> (dt, B, C); softplus(dt)
  selective_scan (K1) forward over the nb streams, reverse over the nr
  inv_perm_weighted_sum (K3) with the softmax direction gate
  y * silu(gate) -> out_proj

On the CPU the kernels' plain versions run; the JAX layer's own f32 CPU
path is its generic formulation, which its tests hold equal to the lane
path.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.dirstream import dir_conv_silu, inv_perm_weighted_sum
from ..ops.scan_paths import base_paths, inverse_permutation, path_spec
from ..ops.selective_scan import selective_scan
from .layers import Conv, Dense, LayerNorm, _lecun_normal_

STATE_SIZE = 16          # Mamba state n (the reference's MambaMixer config)
CONV_KERNEL = 4          # depthwise conv taps along tokens

_GENERIC_PATHS = ("path types with a shuffle stream, the per-sample gate or "
                  "no scan ('multi_clock_gate') are not ported yet: ROADMAP "
                  "Queue 1, 'the generic and shuffle Mamba paths'")


class CausalDWConv(nn.Module):
    """Taps of the depthwise k-tap conv along tokens: weight (k, d),
    bias (d,). The fused directional kernel consumes them directly."""

    flax_kernel = "taps"     # convert.py: (k, 1, d) <-> (k, d)

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(CONV_KERNEL, features))
        self.bias = nn.Parameter(torch.empty(features))

    def reset_parameters(self, g: torch.Generator):
        _lecun_normal_(self.weight, self.weight.shape[0], g)
        nn.init.zeros_(self.bias)


class DualLayoutDense(Dense):
    """Dense applied in the lane-major layout: (..., in, b) -> (..., out, b),
    so the projections of the streams need no transposes."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, dt_init: bool = False):
        super().__init__(in_features, out_features, use_bias)
        self.dt_init = dt_init

    def reset_parameters(self, g: torch.Generator):
        if not self.dt_init:
            return super().reset_parameters(g)
        # Mamba dt projection: kernel U[0, 2 rank^-0.5) (flax uniform),
        # bias = softplus^-1 of dt ~ LogUniform[1e-3, 1e-1]
        nn.init.uniform_(self.weight, 0.0,
                         2 * self.weight.shape[1] ** -0.5, generator=g)
        u = torch.rand(self.bias.shape, generator=g)
        dt = torch.exp(u * (math.log(0.1) - math.log(0.001))
                       + math.log(0.001)).clamp_min(1e-4)
        self.bias.copy_(dt + torch.log(-torch.expm1(-dt)))

    def forward(self, x):
        y = torch.matmul(self.weight, x)
        if self.bias is not None:
            y = y + self.bias[:, None]
        return y


class MultiDirMambaLayer(nn.Module):
    """One multi-directional Mamba layer over ``num_tokens`` tokens:
    the mixer over every static ordering, combined with the direction
    gate (ref: Mutimodality_Mamba7.py:608-701)."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 path_type: str, num_tokens: int):
        super().__init__()
        spec = path_spec(path_type)
        if spec.identity or spec.n_shuffle or spec.combine == "dynamic":
            raise NotImplementedError(
                "path_type {!r}: {}".format(path_type, _GENERIC_PATHS))
        self.combine = spec.combine
        d, n = intermediate_size, STATE_SIZE
        self.tsr = math.ceil(hidden_size / 16)           # time-step rank

        orders, bases, fwd_dir, rev_dir = base_paths(path_type, num_tokens)
        self.n_dir = len(orders)
        rev_rows = [i for i, r in enumerate(rev_dir) if r >= 0]
        i32 = torch.int32
        self.register_buffer("orders", torch.tensor(
            np.stack([orders[i] for i in bases]), dtype=i32), persistent=False)
        self.register_buffer("inv_orders", torch.tensor(
            np.stack([inverse_permutation(orders[i]) for i in bases]),
            dtype=i32), persistent=False)
        self.register_buffer("rev_rows", torch.tensor(rev_rows, dtype=i32),
                             persistent=False)
        # direction index served by each base's forward / reverse scan
        self.register_buffer("fwd_dir", torch.tensor(fwd_dir),
                             persistent=False)
        self.register_buffer("rev_dir", torch.tensor(
            [rev_dir[i] for i in rev_rows], dtype=torch.int64),
            persistent=False)

        self.in_proj = Dense(hidden_size, 2 * d, use_bias=False)
        self.conv1d = CausalDWConv(d)
        self.x_proj = DualLayoutDense(d, self.tsr + 2 * n, use_bias=False)
        self.dt_proj = DualLayoutDense(self.tsr, d, use_bias=True,
                                       dt_init=True)
        self.A_log = nn.Parameter(torch.empty(d, n))
        self.D = nn.Parameter(torch.empty(d))
        if self.combine in ("softmax10", "raw10"):
            # the reference's gate is always a 10-slot parameter
            self.direction_gate = nn.Parameter(torch.empty(10))
        self.out_proj = Dense(d, hidden_size, use_bias=False)

    def reset_parameters(self, g: torch.Generator):
        self.A_log.copy_(torch.log(torch.arange(
            1, STATE_SIZE + 1, dtype=torch.float32))[None].expand_as(
                self.A_log))
        nn.init.ones_(self.D)
        if hasattr(self, "direction_gate"):
            nn.init.zeros_(self.direction_gate)

    def _direction_weights(self):
        if self.combine == "softmax10":
            # softmax over all 10 slots, the first n_dir used (ref: :360)
            return torch.softmax(self.direction_gate, dim=0)[:self.n_dir]
        if self.combine == "raw10":
            return self.direction_gate[:self.n_dir]
        fill = 1.0 / self.n_dir if self.combine == "mean" else 1.0
        return self.D.new_full((self.n_dir,), fill)

    def _ssm_inputs(self, uc):
        """(ns, L, d, B) streams -> dt (softplus), B, C in that layout."""
        tsr, n = self.tsr, STATE_SIZE
        ssm = self.x_proj(uc)                           # (ns, L, tsr+2n, B)
        # F.softplus goes linear above threshold 20, where log1p(exp(-x))
        # is below float32 resolution of x: the same values as flax's
        # logaddexp(x, 0)
        dt = F.softplus(self.dt_proj(ssm[:, :, :tsr]))
        return (dt.contiguous(), ssm[:, :, tsr:tsr + n].contiguous(),
                ssm[:, :, tsr + n:].contiguous())

    def forward(self, x):
        u, gate = self.in_proj(x).chunk(2, dim=-1)        # (B, L, d)
        u_lm = u.permute(1, 2, 0).contiguous()            # (L, d, B)
        uf, ur = dir_conv_silu(u_lm, self.conv1d.weight, self.conv1d.bias,
                               self.orders, self.rev_rows)
        A = -torch.exp(self.A_log)

        dtf, Bf, Cf = self._ssm_inputs(uf)
        y_fwd = selective_scan(uf, dtf, A, Bf, Cf, self.D)   # (nb, L, d, B)
        w = self._direction_weights()
        if self.rev_rows.numel():
            dtr, Br, Cr = self._ssm_inputs(ur)
            y_rev = selective_scan(ur, dtr, A, Br, Cr, self.D, reverse=True)
        else:
            y_rev = y_fwd.new_zeros((0,) + tuple(y_fwd.shape[1:]))
        y = inv_perm_weighted_sum(y_fwd, y_rev, w[self.fwd_dir],
                                  w[self.rev_dir], self.inv_orders,
                                  self.rev_rows)
        y = y.permute(2, 0, 1)                            # (B, L, d)
        return self.out_proj(y * F.silu(gate))


class DirectionalMambaBackbone(nn.Module):
    """1x1-conv patch embed + learnable position embedding + layers of
    (pre-LN -> multi-directional Mamba layer) with residual, final LN;
    returns the (B, H, W, C) feature map.

    Other position embeddings, cls tokens and output types raise."""

    def __init__(self, embed_dims: int, num_layers: int,
                 feedforward_channels: int, img_size: int, in_channels: int,
                 path_type: str = "81_2+8", out_type: str = "featmap",
                 pe_type: str = "learnable", cls_position: str = "none"):
        super().__init__()
        if (pe_type, cls_position, out_type) != ("learnable", "none",
                                                 "featmap"):
            raise NotImplementedError(
                "pe_type={!r}, cls_position={!r}, out_type={!r}: only the "
                "flagship's ('learnable', 'none', 'featmap') is ported; the "
                "rest is ROADMAP Queue 1, 'nn/mamba.py'".format(
                    pe_type, cls_position, out_type))
        self.embed_dims = embed_dims
        self.num_layers = num_layers
        L = img_size * img_size
        self.patch_embed = Conv(in_channels, embed_dims, 1, use_bias=False)
        self.pos_embed = nn.Parameter(torch.empty(1, L, embed_dims))
        for i in range(num_layers):
            setattr(self, "pre_norm{}".format(i), LayerNorm(embed_dims))
            setattr(self, "mixer{}".format(i), MultiDirMambaLayer(
                embed_dims, feedforward_channels, path_type, L))
        if num_layers:
            self.ln1 = LayerNorm(embed_dims)

    def reset_parameters(self, g: torch.Generator):
        nn.init.trunc_normal_(self.pos_embed, 0.0, 0.02, -0.04, 0.04,
                              generator=g)

    def forward(self, x):
        b, h, w, _ = x.shape
        tokens = self.patch_embed(x).reshape(b, h * w, self.embed_dims)
        tokens = tokens + self.pos_embed
        for i in range(self.num_layers):
            normed = getattr(self, "pre_norm{}".format(i))(tokens)
            tokens = tokens + getattr(self, "mixer{}".format(i))(normed)
        if self.num_layers:
            tokens = self.ln1(tokens)
        return tokens.reshape(b, h, w, self.embed_dims)
