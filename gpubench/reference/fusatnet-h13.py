"""Plain float32 reference of FusAtNet (Mohla et al., CVPR-W 2020; the
MMRS registry entry, model_utils.py:109-118), channel-last, on a
state_dict with the port's names.

Copied from the port's plain path (``vit_cnn_tpu_torch/models/
fusatnet.py`` and ``nn/layers.py``) with every op written out: 3 x 3
convs, the flax BatchNorm (eval: running statistics; train: the batch's
float32 mean and biased fast variance max(E[x^2] - E[x]^2, 0), running
statistics 0.9 old + 0.1 batch), ReLU, VALID 2 x 2 max pools and the
spectral gate's average pool. ``mm`` rounds both operands and the result
of every product (:mod:`gpubench.precision`); it imports nothing of the
program.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

EPS = 1e-5
DECAY = 0.9


def _ident(x):
    return x


class Net:
    """FusAtNet's forward over ``sd``; ``train`` normalises by the batch
    and writes the new running statistics into ``stats``."""

    def __init__(self, sd: Dict[str, torch.Tensor], mm: Optional[Callable],
                 train: bool = False, stats: Optional[Dict] = None):
        self.sd, self.mm = sd, mm or _ident
        self.train, self.stats = train, stats

    def conv(self, name, x, padding):
        w, b = self.sd[name + ".weight"], self.sd[name + ".bias"]
        if w.shape[2] == 1 and w.shape[3] == 1 and padding == 0:
            return self.mm(F.linear(self.mm(x), self.mm(w[:, :, 0, 0]), b))
        y = F.conv2d(self.mm(x.movedim(-1, 1)), self.mm(w), b,
                     padding=padding)
        return self.mm(y.movedim(1, -1))

    def bn(self, name, x):
        p = name + ".bn."
        if self.train:
            mean = x.mean(dim=(0, 1, 2))
            var = ((x * x).mean(dim=(0, 1, 2)) - mean * mean).clamp_min(0)
            with torch.no_grad():
                self.stats[p + "running_mean"] = (
                    DECAY * self.sd[p + "running_mean"] + (1 - DECAY) * mean)
                self.stats[p + "running_var"] = (
                    DECAY * self.sd[p + "running_var"] + (1 - DECAY) * var)
        else:
            mean, var = self.sd[p + "running_mean"], self.sd[p + "running_var"]
        mul = torch.rsqrt(var + EPS) * self.sd[p + "weight"]
        return (x - mean) * mul + self.sd[p + "bias"]

    def unit(self, name, x, padding=1):
        """ConvBNReLU."""
        x = self.conv(name + ".Conv_0", x, padding)
        return torch.relu(self.bn(name + ".BatchNorm_0", x))

    def res(self, name, x, pooled=False):
        x = self.unit(name + ".ConvBNReLU_0", x)
        x = self.unit(name + ".ConvBNReLU_1", x) + x
        return pool(x) if pooled else x

    def tower(self, name, x):
        for i in range(6):
            x = self.unit("{}.ConvBNReLU_{}".format(name, i), x)
        return x

    def attention(self, name, x):
        x = self.res(name + "._ResUnit_1", self.res(name + "._ResUnit_0", x))
        return self.unit(name + ".ConvBNReLU_1",
                         self.unit(name + ".ConvBNReLU_0", x))

    def __call__(self, hsi, lidar):
        fhs = self.tower("hfe", hsi)
        sa = self.res("_ResUnitPooled_1", self.res("_ResUnitPooled_0", hsi,
                                                   True), True)
        sa = self.unit("ConvBNReLU_1", self.unit("ConvBNReLU_0", sa))
        sa = pool(sa).mean(dim=(1, 2))[:, None, None, :]
        ms = sa * fhs
        mt = self.attention("spatial_am", lidar) * fhs
        stacked = torch.cat([hsi, lidar, ms, mt], dim=-1)
        x = self.tower("mfe", stacked) * self.attention("mam", stacked)
        for i in range(2, 7):
            x = self.unit("ConvBNReLU_{}".format(i), x, padding=0)
        return self.conv("Conv_0", x, 0)[:, 0, 0]


def pool(x):
    """VALID 2 x 2 max pool of (B, H, W, C) (11 -> 5 -> 2)."""
    b, h, w, c = x.shape
    x = x[:, :h // 2 * 2, :w // 2 * 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def forward(sd, hsi, lidar, mm=None):
    """Eval-mode logits (B, K) of (B, 11, 11, bands) windows, float32."""
    with torch.no_grad():
        return Net(sd, mm)(hsi.float(), lidar.float())


def train_forward(sd, hsi, lidar, mm=None):
    """Train-mode logits (differentiable in ``sd``'s tensors) and the
    running statistics this batch leaves."""
    stats: Dict[str, torch.Tensor] = {}
    out = Net(sd, mm, train=True, stats=stats)(hsi.float(), lidar.float())
    return out, stats
