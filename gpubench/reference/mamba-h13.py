"""Plain float32 reference of Multimodality_Mamba (lmwdhr/ViT-CNN
model_utils.py:297-313, Mutimodality_Mamba7.py:1141-1181), channel-last,
on a state_dict with the port's names.

Copied from the port's plain path (``vit_cnn_tpu_torch/models/
mm_mamba.py``, ``nn/mamba.py``, ``nn/layers.py``, ``ops/scan_paths.py``
and the plain versions in ``ops/``) and written in the upstream form
rather than the port's lane-major one: each of the ten scan directions
of a '{L}_2+8' layer gathers the tokens in its own order, runs the
causal 4-tap conv + SiLU, the projections and the selective scan
forward, and is put back in token order; the directions are mixed by
softmax(direction_gate). Norms are flax's (float32 statistics, fast
variance; LayerNorm eps 1e-6, BatchNorm 1e-5, eval mode). ``mm`` rounds
both operands and the result of every product (:mod:`gpubench.precision`);
the scan's recurrence is elementwise and stays float32. It imports
nothing of the program.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

STATE = 16
TAPS = 4


def _ident(x):
    return x


# --------------------------------------------------------------- orderings
def _row_major(n):
    return np.arange(n * n)


def _col_boustrophedon(n):
    idx = []
    for c in range(n):
        rows = range(n) if c % 2 == 0 else range(n - 1, -1, -1)
        idx += [r * n + c for r in rows]
    return np.array(idx)


def _zigzag(n):
    idx = []
    for d in range(2 * n - 1):
        cells = [(r, d - r) for r in range(n) if 0 <= d - r < n]
        cells = sorted(cells, key=lambda rc: rc[0], reverse=(d % 2 == 0))
        idx += [r * n + c for r, c in cells]
    return np.array(idx)


def _zigzag_mirror(n):
    o = _zigzag(n)
    return (o // n) * n + (n - 1 - o % n)


def _spiral(n, clockwise):
    idx = []
    top, bot, left, right = 0, n - 1, 0, n - 1
    while top <= bot and left <= right:
        if clockwise:
            idx += [top * n + c for c in range(left, right + 1)]
            idx += [r * n + right for r in range(top + 1, bot + 1)]
            if top < bot:
                idx += [bot * n + c for c in range(right - 1, left - 1, -1)]
            if left < right:
                idx += [r * n + left for r in range(bot - 1, top, -1)]
        else:
            idx += [r * n + left for r in range(top, bot + 1)]
            idx += [bot * n + c for c in range(left + 1, right + 1)]
            if left < right:
                idx += [r * n + right for r in range(bot - 1, top - 1, -1)]
            if top < bot:
                idx += [top * n + c for c in range(right - 1, left, -1)]
        top += 1
        bot -= 1
        left += 1
        right -= 1
    return np.array(idx)


def orderings(n: int):
    """The ten orderings of '{n*n}_2+8' (ref: Mutimodality_Mamba7.py:
    608-701): row-major and reversed, column boustrophedon and reversed,
    zigzag and reversed, mirrored zigzag and reversed, clockwise and
    anticlockwise spirals."""
    r, v, z, m = _row_major(n), _col_boustrophedon(n), _zigzag(n), \
        _zigzag_mirror(n)
    return [r, r[::-1], v, v[::-1], z, z[::-1], m, m[::-1],
            _spiral(n, True), _spiral(n, False)]


# ------------------------------------------------------------------ layers
class Net:
    def __init__(self, sd: Dict[str, torch.Tensor],
                 mm: Optional[Callable] = None):
        self.sd, self.mm = sd, mm or _ident

    def w(self, name):
        return self.sd[name]

    def dense(self, name, x, bias=True):
        """x W^T (+ b); a 1 x 1 conv weight (out, in, 1, 1) too."""
        w = self.w(name + ".weight")
        w = w.reshape(w.shape[0], w.shape[1])
        b = self.sd.get(name + ".bias") if bias else None
        return self.mm(F.linear(self.mm(x), self.mm(w), b))

    def conv3(self, name, x):
        """VALID 3 x 3 conv, channel-last."""
        y = F.conv2d(self.mm(x.movedim(-1, 1)),
                     self.mm(self.w(name + ".weight")),
                     self.w(name + ".bias"))
        return self.mm(y.movedim(1, -1))

    def ln(self, name, x, eps=1e-6):
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x * x).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0)
        y = (x - mean) * (torch.rsqrt(var + eps) * self.w(name + ".weight"))
        return y + self.w(name + ".bias")

    def bn(self, name, x):
        mul = torch.rsqrt(self.w(name + ".running_var") + 1e-5) * \
            self.w(name + ".weight")
        return (x - self.w(name + ".running_mean")) * mul + \
            self.w(name + ".bias")

    # ---------------------------------------------------------------- mamba
    def mixer(self, name, x, side):
        """'{L}_2+8' multi-directional Mamba layer on (B, L, hidden)."""
        p = name + "."
        b, L, hidden = x.shape
        d = self.w(p + "D").shape[0]
        tsr = math.ceil(hidden / 16)
        u, gate = self.dense(p + "in_proj", x, bias=False).chunk(2, dim=-1)
        A = -torch.exp(self.w(p + "A_log"))                     # (d, n)
        D = self.w(p + "D")
        taps, tb = self.w(p + "conv1d.weight"), self.w(p + "conv1d.bias")
        weights = torch.softmax(self.w(p + "direction_gate"), dim=0)
        out = torch.zeros_like(u)
        for i, order in enumerate(orderings(side)):
            order = torch.as_tensor(order.copy(), device=x.device)
            ui = u[:, order]                                    # (B, L, d)
            # causal depthwise conv: tap j reads token t - (TAPS - 1 - j)
            acc = tb + torch.zeros_like(ui)
            for j in range(TAPS):
                s = TAPS - 1 - j
                shifted = F.pad(ui, (0, 0, s, 0))[:, :L] if s else ui
                acc = acc + taps[j] * shifted
            uc = F.silu(acc)
            ssm = self.mm(F.linear(self.mm(uc),
                                   self.mm(self.w(p + "x_proj.weight"))))
            dt = F.softplus(self.mm(F.linear(
                self.mm(ssm[..., :tsr]), self.mm(self.w(p + "dt_proj.weight")),
                self.w(p + "dt_proj.bias"))))
            Bm, Cm = ssm[..., tsr:tsr + STATE], ssm[..., tsr + STATE:]
            y = scan(uc, dt, A, Bm, Cm, D)
            inv = torch.argsort(order)
            out = out + weights[i] * y[:, inv]
        return self.dense(p + "out_proj", out * F.silu(gate), bias=False)

    def backbone(self, name, x):
        b, h, w, c = x.shape
        p = name + "."
        t = self.dense(p + "patch_embed", x, bias=False).reshape(b, h * w, -1)
        t = t + self.w(p + "pos_embed")
        t = t + self.mixer(p + "mixer0", self.ln(p + "pre_norm0", t), h)
        return self.ln(p + "ln1", t).reshape(b, h, w, -1)

    # --------------------------------------------------------------- blocks
    def token_learner(self, name, x):
        combined = torch.cat([x.amax(dim=-1, keepdim=True),
                              x.mean(dim=-1, keepdim=True)], dim=-1)
        a = self.bn(name + ".bn.bn", self.dense(name + ".conv", combined))
        weight = torch.sigmoid(torch.relu(a))
        return self.mm(torch.einsum("bhwc,bhws->bsc", self.mm(x),
                                    self.mm(weight))) / (x.shape[1]
                                                         * x.shape[2])

    def non_local(self, name, x, y, z):
        p = name + "."
        b, h, w, _ = x.shape
        theta = self.dense(p + "theta", x)
        phi = pool(self.dense(p + "phi", y))
        g = pool(self.dense(p + "g", z))
        q = theta.reshape(b, h * w, -1)
        k = phi.reshape(b, -1, q.shape[-1])
        v = g.reshape(b, -1, q.shape[-1])
        s = self.mm(torch.einsum("gid,gjd->gij", self.mm(q), self.mm(k)))
        a = self.mm(torch.einsum("gij,gjd->gid",
                                 self.mm(torch.softmax(s, dim=-1)),
                                 self.mm(v))).reshape(b, h, w, -1)
        return self.bn(p + "W_bn", self.dense(p + "W_conv", a)) + z

    def ms_conv(self, name, x):
        """BN -> VALID 3 x 3 conv -> ReLU."""
        return torch.relu(self.conv3(name + ".Conv_0",
                                     self.bn(name + ".BatchNorm_0.bn", x)))

    def fusion(self, name, x1, x2):
        if x1.shape[-1] == x2.shape[-1]:
            even = torch.arange(x1.shape[-1], device=x1.device) % 2 == 0
            x1, x2 = torch.where(even, x2, x1), torch.where(even, x1, x2)
        x = self.dense(name + ".Conv_0", torch.cat([x1, x2], dim=-1))
        return torch.relu(self.bn(name + ".BatchNorm_0.bn", x))

    def gl_fusion(self, name, x1, x2):
        globalf = x2 + x1
        localf = self.non_local(name + ".cross_attention", x2, x1, x1) + x2
        x = self.dense(name + ".Conv_0", torch.cat([localf, globalf], dim=-1))
        return torch.relu(self.bn(name + ".BatchNorm_0.bn", x))

    def global_local(self, name, hsi):
        p = name + "."
        b, s = hsi.shape[0], hsi.shape[1] - 2
        gf = self.dense(p + "change_dim",
                        self.backbone(p + "global_view", hsi))
        gf = self.ln(p + "ln3", self.token_learner(p + "global_tokens", gf))
        gf = gf.reshape(b, s, s, -1)
        local = self.ms_conv(p + "local_feature", hsi)
        cf = self.token_learner(p + "channel_tokens",
                                self.dense(p + "channel_feature", hsi))
        cf = self.ln(p + "ln4", cf).reshape(b, s, s, -1)
        return self.fusion(p + "fusion", gf,
                           self.gl_fusion(p + "gl_fusion", cf, local))

    def __call__(self, hsi, lidar):
        hsi1 = self.global_local("hsi1", hsi)
        hsi2 = self.global_local("hsi2", hsi1)
        lidar1 = self.ms_conv("lidar1", lidar)
        lidar2 = self.ms_conv("lidar2", lidar1)
        f1 = self.fusion("fusion1", hsi1, lidar1)
        f2 = self.fusion("fusion2", hsi2, lidar2)
        return self.dense("classifier",
                          f1.mean(dim=(1, 2)) + f2.mean(dim=(1, 2)))


def scan(u, dt, A, B, C, D):
    """Selective scan over (B, L, d) with (B, L, n) B and C:
    h_t = exp(dt_t A) h_{t-1} + dt_t u_t B_t; y_t = C_t . h_t + D u_t."""
    b, L, d = u.shape
    h = u.new_zeros((b, d, A.shape[1]))
    ys = []
    for t in range(L):
        dA = torch.exp(dt[:, t, :, None] * A)
        h = dA * h + (dt[:, t] * u[:, t])[:, :, None] * B[:, t, None, :]
        ys.append((h * C[:, t, None, :]).sum(dim=-1) + D * u[:, t])
    return torch.stack(ys, dim=1)


def pool(x):
    """VALID 2 x 2 max pool of (B, H, W, C)."""
    b, h, w, c = x.shape
    x = x[:, :h // 2 * 2, :w // 2 * 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def forward(sd, hsi, lidar, mm=None):
    """Eval-mode logits (B, K) of (B, 9, 9, bands) windows, float32."""
    with torch.no_grad():
        return Net(sd, mm)(hsi.float(), lidar.float())
