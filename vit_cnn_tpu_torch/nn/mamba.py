"""The Mamba mixer, the multi-directional vision-Mamba layer and backbone.

Port of :mod:`vit_cnn_tpu.nn.mamba`, the reference's whole ``hsiMamba``
surface (ref: Mutimodality_Mamba7.py:176-1032). Every layer runs in the
kernels' lane-major (L, d, b) layout, as the JAX lane-major path does
(``MultiDirMambaLayer``, vit_cnn_tpu/nn/mamba.py lane branch):

  in_proj -> (u, gate); u to (L, d, B)
  dir_conv_silu (K2): every base order's gather + causal conv + SiLU, and
      the anti-causal twin for orders whose exact reverse is a direction
  x_proj / dt_proj in that layout -> (dt, B, C); softplus(dt)
  selective_scan (K1) forward over the nb streams, reverse over the nr
  inv_perm_weighted_sum (K3) with the direction weights
  y * silu(gate) -> out_proj

Path types with a shuffle stream draw its permutation on every call
(train and eval, as upstream's ``torch.randperm``) through
:func:`.noise.permutation`, and append it to the static order tables as
one more base with no reverse twin, so it takes the same K2 -> K1 -> K3
path (K6 / K7 / K5 backward; the autograd Functions keep the drawn
tables for the backward). The per-sample gate ('forward_reverse_gate')
needs its directions apart: each stream is put back in token order by a
plain gather with its inverse order instead of K3. On the CPU the
kernels' plain versions run; the JAX layer's own float32 CPU path is its
generic formulation, which its tests hold equal to the lane path.
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
from . import noise
from .layers import Conv, Dense, LayerNorm, _lecun_normal_

STATE_SIZE = 16          # Mamba state n (the reference's MambaMixer config)
CONV_KERNEL = 4          # depthwise conv taps along tokens
#: tokens added by each cls_position (ref: :424-436)
CLS_TOKENS = {"none": 0, "head": 1, "tail": 1, "middle": 1, "head_tail": 2}
OUT_TYPES = ("raw", "cls_token", "featmap", "avg_featmap")
PE_TYPES = ("learnable", "sine", "none")


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


class MambaMixer(nn.Module):
    """HuggingFace ``MambaMixer`` as the reference configures it (state
    16, conv 4, time-step rank ceil(hidden / 16), conv bias, no Dense
    bias; ref: :313-326): (B, L, hidden) -> (B, L, hidden), one causal
    sequence per sample, with the Mamba dt init.

    The sequences go to the lane-major (1, L, d, B) layout once: the
    causal conv + SiLU runs as K2 with the identity order (one row of
    ``arange(L)``, no reverse stream), which computes what JAX's
    ``lax.conv`` + SiLU does; the scan is K1 on that single stream, and
    the result comes back to (B, L, d) for the gate and out_proj."""

    def __init__(self, hidden_size: int, intermediate_size: int):
        super().__init__()
        d, n = intermediate_size, STATE_SIZE
        self.tsr = math.ceil(hidden_size / 16)           # time-step rank
        self.in_proj = Dense(hidden_size, 2 * d, use_bias=False)
        self.conv1d = CausalDWConv(d)
        self.x_proj = DualLayoutDense(d, self.tsr + 2 * n, use_bias=False)
        self.dt_proj = DualLayoutDense(self.tsr, d, use_bias=True,
                                       dt_init=True)
        self.A_log = nn.Parameter(torch.empty(d, n))
        self.D = nn.Parameter(torch.empty(d))
        self.out_proj = Dense(d, hidden_size, use_bias=False)

    def reset_parameters(self, g: torch.Generator):
        self.A_log.copy_(torch.log(torch.arange(
            1, STATE_SIZE + 1, dtype=torch.float32))[None].expand_as(
                self.A_log))
        nn.init.ones_(self.D)

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

    def _streams(self, x, orders, rev_rows):
        """in_proj, then K2 over ``orders`` and K1 forward (and reverse
        over ``rev_rows``): (y_fwd (nb, L, d, B), y_rev (nr, L, d, B),
        gate (B, L, d))."""
        u, gate = self.in_proj(x).chunk(2, dim=-1)        # (B, L, d)
        u_lm = u.permute(1, 2, 0).contiguous()            # (L, d, B)
        uf, ur = dir_conv_silu(u_lm, self.conv1d.weight, self.conv1d.bias,
                               orders, rev_rows)
        A = -torch.exp(self.A_log)
        dtf, Bf, Cf = self._ssm_inputs(uf)
        y_fwd = selective_scan(uf, dtf, A, Bf, Cf, self.D)
        if rev_rows.numel():
            dtr, Br, Cr = self._ssm_inputs(ur)
            y_rev = selective_scan(ur, dtr, A, Br, Cr, self.D, reverse=True)
        else:
            y_rev = y_fwd.new_zeros((0,) + tuple(y_fwd.shape[1:]))
        return y_fwd, y_rev, gate

    def forward(self, x):
        L = x.shape[1]
        identity = torch.arange(L, dtype=torch.int32, device=x.device)[None]
        none = torch.zeros((0,), dtype=torch.int32, device=x.device)
        y, _, gate = self._streams(x, identity, none)
        y = y[0].permute(2, 0, 1)                         # (B, L, d)
        return self.out_proj(y * F.silu(gate))


class MultiDirMambaLayer(MambaMixer):
    """One multi-directional Mamba layer over ``num_tokens`` tokens: the
    mixer over every ordering of ``path_type``, combined by the path's
    gate (ref: Mutimodality_Mamba7.py:444-987, one literal branch per
    path type; :func:`..ops.scan_paths.path_spec`). The parameters are one
    shared :class:`MambaMixer`'s, plus the 10-slot ``direction_gate``
    (softmax10 / raw10 paths) or the per-sample ``gate`` Dense
    (n_dir * hidden -> n_dir, no bias; 'forward_reverse_gate').

    Direction slots follow JAX's ``fwd_dir_all``: the static orderings
    first, then shuffle stream k at ``n_static + k``."""

    def __init__(self, hidden_size: int, intermediate_size: int,
                 path_type: str, num_tokens: int):
        super().__init__(hidden_size, intermediate_size)
        spec = path_spec(path_type)
        self.combine, self.n_shuffle = spec.combine, spec.n_shuffle
        L = num_tokens
        # raises for 'multi_clock_gate' (no layer: the backbone skips it)
        # and for grid paths over a token count that is not a square
        orders, bases, fwd_dir, rev_dir = base_paths(path_type, L)
        n_static = len(orders)
        self.n_dir = n_static + spec.n_shuffle
        self._rev_rows = [i for i, r in enumerate(rev_dir) if r >= 0]
        # direction slot served by each base's forward / reverse scan
        self._fwd_dir = list(fwd_dir) + [n_static + k
                                         for k in range(spec.n_shuffle)]
        self._rev_dir = [rev_dir[i] for i in self._rev_rows]
        i32, i64 = torch.int32, torch.int64
        table = np.array([orders[i] for i in bases], np.int64).reshape(-1, L)
        self.register_buffer("orders", torch.tensor(table, dtype=i32),
                             persistent=False)
        self.register_buffer("inv_orders", torch.tensor(
            np.array([inverse_permutation(o) for o in table],
                     np.int64).reshape(-1, L), dtype=i32), persistent=False)
        self.register_buffer("rev_rows", torch.tensor(self._rev_rows,
                                                      dtype=i32),
                             persistent=False)
        self.register_buffer("fwd_dir", torch.tensor(self._fwd_dir,
                                                     dtype=i64),
                             persistent=False)
        self.register_buffer("rev_dir", torch.tensor(self._rev_dir,
                                                     dtype=i64),
                             persistent=False)
        if self.combine in ("softmax10", "raw10"):
            # the reference's gate is always a 10-slot parameter
            self.direction_gate = nn.Parameter(torch.empty(10))
        if self.combine == "dynamic":
            self.gate = Dense(self.n_dir * hidden_size, self.n_dir,
                              use_bias=False)

    def reset_parameters(self, g: torch.Generator):
        super().reset_parameters(g)
        if hasattr(self, "direction_gate"):
            nn.init.zeros_(self.direction_gate)

    def _tables(self, L, device):
        """(orders, inv_orders) of this call: the static rows, then one
        freshly drawn permutation per shuffle stream."""
        if not self.n_shuffle:
            return self.orders, self.inv_orders
        rows, invs = [self.orders], [self.inv_orders]
        for _ in range(self.n_shuffle):
            p = noise.permutation(L, device)
            rows.append(p.to(torch.int32)[None])
            invs.append(torch.argsort(p).to(torch.int32)[None])
        return torch.cat(rows), torch.cat(invs)

    def _direction_weights(self):
        if self.combine == "softmax10":
            # softmax over all 10 slots, the first n_dir used (ref: :360)
            return torch.softmax(self.direction_gate, dim=0)[:self.n_dir]
        if self.combine == "raw10":
            # eight_directions_gate applies no softmax (ref: :514-515)
            return self.direction_gate[:self.n_dir]
        fill = 1.0 / self.n_dir if self.combine == "mean" else 1.0
        return self.D.new_full((self.n_dir,), fill)

    def _per_sample(self, y_fwd, y_rev, inv, gate):
        """'forward_reverse_gate' (ref: :936-947): the restored directions
        gated by silu(gate), a softmax over ``gate`` of their out_proj'd
        token means per sample, the mix, out_proj. Token means commute
        with the inverse permutation and out_proj is linear and bias-free,
        as in the JAX layer."""
        dirs = [None] * self.n_dir
        inv = inv.long()
        for i, slot in enumerate(self._fwd_dir):
            dirs[slot] = y_fwd[i].index_select(0, inv[i])
        for j, (r, slot) in enumerate(zip(self._rev_rows, self._rev_dir)):
            dirs[slot] = y_rev[j].index_select(0, inv[r])
        g = torch.stack(dirs).permute(0, 3, 1, 2) * F.silu(gate)[None]
        means = self.out_proj(g.mean(dim=2))              # (n_dir, B, h)
        dyn = torch.softmax(self.gate(torch.cat(list(means), dim=-1)),
                            dim=-1)                       # (B, n_dir)
        return self.out_proj(torch.einsum("nbld,bn->bld", g, dyn))

    def forward(self, x):
        orders, inv = self._tables(x.shape[1], x.device)
        y_fwd, y_rev, gate = self._streams(x, orders, self.rev_rows)
        if self.combine == "dynamic":
            return self._per_sample(y_fwd, y_rev, inv, gate)
        w = self._direction_weights()
        y = inv_perm_weighted_sum(y_fwd, y_rev, w[self.fwd_dir],
                                  w[self.rev_dir], inv, self.rev_rows)
        y = y.permute(2, 0, 1)                            # (B, L, d)
        return self.out_proj(y * F.silu(gate))


def sincos_2d_position_embedding(h: int, w: int, embed_dims: int,
                                 temperature: float = 10000.0) -> np.ndarray:
    """Fixed 2D sine-cosine position embedding (1, h * w, embed_dims),
    float32, replicating ref: mmpretrain/models/utils/
    position_encoding.py:123-173 (including its 'ij' meshgrid over
    (w, h): the w index varies slowest in the flattened token order)."""
    assert embed_dims % 4 == 0, "embed dims must be divisible by 4"
    grid_w, grid_h = np.meshgrid(np.arange(w, dtype=np.float32),
                                 np.arange(h, dtype=np.float32),
                                 indexing="ij")
    pos_dim = embed_dims // 4
    omega = 1.0 / temperature ** (
        np.arange(pos_dim, dtype=np.float32) / pos_dim)
    out_w = grid_w.reshape(-1)[:, None] * omega[None]
    out_h = grid_h.reshape(-1)[:, None] * omega[None]
    return np.concatenate([np.sin(out_w), np.cos(out_w),
                           np.sin(out_h), np.cos(out_h)],
                          axis=1)[None].astype(np.float32)


class DirectionalMambaBackbone(nn.Module):
    """1x1-conv patch embed (no bias) + cls tokens + position embedding +
    dropout + layers of (pre-LN -> multi-directional Mamba layer) with
    residual, final LN ``ln1``; then the output by ``out_type``.

    * ``path_type``: every path of :func:`..ops.scan_paths.path_spec`;
      'multi_clock_gate' builds no ``pre_norm{i}`` / ``mixer{i}``: each
      layer doubles the tokens (residual + tokens), ``ln1`` still applies.
    * ``pe_type``: 'learnable' (``pos_embed`` (1, L, C), trunc-normal
      0.02), 'sine' (fixed, no parameter, no cls tokens) or 'none'. The
      sine embedding is added in the tokens' dtype (the JAX backbone's
      float32 constant promotes bf16 tokens to float32 there).
    * ``cls_position``: 'none', 'head', 'tail', 'head_tail' (2 tokens) or
      'middle', a zeros-initialised ``cls_token`` (1, n_extra, C). Grid
      paths need a square token count, so cls tokens go only with the
      sequence-order paths (base_paths raises, as in JAX).
    * ``out_type``: 'featmap' (B, H, W, C), 'avg_featmap' (LN ``ln2`` of
      the patch-token mean), 'cls_token' (head_tail averages both ends)
      or 'raw' (every token, cls included) (ref: :992-1032).
    * ``drop_rate``: flax dropout after the position embedding, in train
      mode, drawn through :mod:`.noise`.
    """

    def __init__(self, embed_dims: int, num_layers: int,
                 feedforward_channels: int, img_size: int, in_channels: int,
                 path_type: str = "81_2+8", out_type: str = "featmap",
                 pe_type: str = "learnable", cls_position: str = "none",
                 drop_rate: float = 0.0):
        super().__init__()
        if cls_position not in CLS_TOKENS:
            raise ValueError("cls_position {!r} is not one of {}".format(
                cls_position, sorted(CLS_TOKENS)))
        if pe_type not in PE_TYPES:
            raise ValueError("pe_type {!r} is not one of {}".format(
                pe_type, PE_TYPES))
        if out_type not in OUT_TYPES:
            raise ValueError("out_type {!r} is not one of {}".format(
                out_type, OUT_TYPES))
        n_extra = CLS_TOKENS[cls_position]
        if out_type == "cls_token" and not n_extra:
            raise ValueError("out_type=cls_token requires a cls_position")
        self.embed_dims, self.num_layers = embed_dims, num_layers
        self.out_type, self.pe_type = out_type, pe_type
        self.cls_position, self.n_extra = cls_position, n_extra
        self.drop_rate = float(drop_rate)
        self.identity = path_spec(path_type).identity
        L = img_size * img_size + n_extra
        self.patch_embed = Conv(in_channels, embed_dims, 1, use_bias=False)
        if n_extra:
            self.cls_token = nn.Parameter(torch.empty(1, n_extra,
                                                      embed_dims))
        if pe_type == "learnable":
            self.pos_embed = nn.Parameter(torch.empty(1, L, embed_dims))
        elif pe_type == "sine":
            # fixed (ref: :287-293); its cls extension is a TODO upstream
            assert n_extra == 0, "sine pos embed does not support cls tokens"
            self.register_buffer("sine_embed", torch.from_numpy(
                sincos_2d_position_embedding(img_size, img_size,
                                             embed_dims)), persistent=False)
        for i in range(0 if self.identity else num_layers):
            setattr(self, "pre_norm{}".format(i), LayerNorm(embed_dims))
            setattr(self, "mixer{}".format(i), MultiDirMambaLayer(
                embed_dims, feedforward_channels, path_type, L))
        if num_layers:
            self.ln1 = LayerNorm(embed_dims)
        if out_type == "avg_featmap":
            self.ln2 = LayerNorm(embed_dims)

    def reset_parameters(self, g: torch.Generator):
        if hasattr(self, "cls_token"):
            nn.init.zeros_(self.cls_token)
        if hasattr(self, "pos_embed"):
            nn.init.trunc_normal_(self.pos_embed, 0.0, 0.02, -0.04, 0.04,
                                  generator=g)

    def _with_cls(self, tokens):
        cls = self.cls_token.expand(tokens.shape[0], -1, -1)
        if self.cls_position == "head":
            return torch.cat([cls, tokens], dim=1)
        if self.cls_position == "tail":
            return torch.cat([tokens, cls], dim=1)
        if self.cls_position == "head_tail":
            return torch.cat([cls[:, :1], tokens, cls[:, 1:]], dim=1)
        half = tokens.shape[1] // 2                        # middle
        return torch.cat([tokens[:, :half], cls, tokens[:, half:]], dim=1)

    def _output(self, tokens, shape):
        if self.out_type == "raw":
            return tokens                 # cls tokens included (ref: :994)
        pos = self.cls_position
        if self.out_type == "cls_token":  # ref: _format_output :995-1003
            if pos == "head":
                return tokens[:, 0]
            if pos == "tail":
                return tokens[:, -1]
            if pos == "head_tail":
                return (tokens[:, 0] + tokens[:, -1]) / 2
            return tokens[:, tokens.shape[1] // 2]         # middle
        # strip the cls tokens from patch-token outputs (ref: :1005-1016)
        if pos == "head":
            tokens = tokens[:, 1:]
        elif pos == "tail":
            tokens = tokens[:, :-1]
        elif pos == "head_tail":
            tokens = tokens[:, 1:-1]
        elif pos == "middle":
            half = tokens.shape[1] // 2
            tokens = torch.cat([tokens[:, :half], tokens[:, half + 1:]],
                               dim=1)
        if self.out_type == "featmap":
            return tokens.reshape(*shape, self.embed_dims)
        return self.ln2(tokens.mean(dim=1))

    def forward(self, x):
        b, h, w, _ = x.shape
        tokens = self.patch_embed(x).reshape(b, h * w, self.embed_dims)
        if self.n_extra:
            tokens = self._with_cls(tokens)
        if self.pe_type == "learnable":
            tokens = tokens + self.pos_embed
        elif self.pe_type == "sine":
            tokens = tokens + self.sine_embed.to(tokens.dtype)
        tokens = noise.dropout(tokens, self.drop_rate, self.training)
        for i in range(self.num_layers):
            if self.identity:
                # 'multi_clock_gate' matches no scan branch upstream: the
                # residual add doubles the tokens (ref: :441-987, :987)
                tokens = tokens + tokens
            else:
                normed = getattr(self, "pre_norm{}".format(i))(tokens)
                tokens = tokens + getattr(self, "mixer{}".format(i))(normed)
        if self.num_layers:
            tokens = self.ln1(tokens)
        return self._output(tokens, (b, h, w))
