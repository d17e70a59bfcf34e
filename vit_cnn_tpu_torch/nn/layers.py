"""Shared building blocks, NHWC like :mod:`vit_cnn_tpu.nn.layers`.

Parameters follow PyTorch's layouts (Dense weight (out, in), conv weight
OIHW); activations keep the JAX package's channel-last layout, so a port
module and its flax counterpart take and return the same arrays.
:mod:`vit_cnn_tpu_torch.convert` maps flax variables onto these.

Every module creates its parameters empty and fills them in
``reset_parameters(generator)``, with the same initializer families as
the flax modules; :func:`init_parameters` runs them all from one seed.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def _lecun_normal_(w: torch.Tensor, fan_in: int, g: torch.Generator):
    """flax's lecun_normal: truncated normal (+-2 sd) of variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)


class Dense(nn.Module):
    """flax ``nn.Dense``: y = x W^T + b with W (out, in)."""

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = (nn.Parameter(torch.empty(out_features)) if use_bias
                     else None)

    def reset_parameters(self, g: torch.Generator):
        _lecun_normal_(self.weight, self.weight.shape[1], g)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Conv(nn.Module):
    """flax ``nn.Conv`` on NHWC with VALID padding, weight OIHW."""

    def __init__(self, in_features: int, out_features: int,
                 kernel: int = 1, use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, kernel, kernel))
        self.bias = (nn.Parameter(torch.empty(out_features)) if use_bias
                     else None)

    def reset_parameters(self, g: torch.Generator):
        o, i, kh, kw = self.weight.shape
        _lecun_normal_(self.weight, i * kh * kw, g)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        if self.weight.shape[2:] == (1, 1):
            return F.linear(x, self.weight[:, :, 0, 0], self.bias)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias)
        return y.permute(0, 2, 3, 1)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` with eps 1e-6 (every LN of the flagship):
    float32 statistics with the fast variance E[x^2] - E[x]^2 (clipped at
    0), result in x's dtype. torch's own layer_norm takes the two-pass
    variance and differs in the last bits."""

    eps = 1e-6

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def reset_parameters(self, g: torch.Generator):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight.float())
        return (y + self.bias.float()).to(x.dtype)


class ChannelLastBatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` in eval mode over the last axis, with torch's
    momentum 0.1 (flax decay 0.9) and eps 1e-5.

    Serving uses the running statistics only; a training-mode forward
    arrives with the training port (ROADMAP Queue 1) and raises here.
    ``zero_scale`` starts the scale at zero (NonLocal's output BN)."""

    eps = 1e-5
    momentum = 0.1       # the running-stat update of the training port

    def __init__(self, features: int, zero_scale: bool = False):
        super().__init__()
        self.zero_scale = zero_scale
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def reset_parameters(self, g: torch.Generator):
        (nn.init.zeros_ if self.zero_scale else nn.init.ones_)(self.weight)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x):
        if self.training:
            raise NotImplementedError(
                "training-mode BatchNorm comes with the training port "
                "(ROADMAP Queue 1, training); call .eval()")
        mul = torch.rsqrt(self.running_var.float() + self.eps) \
            * self.weight.float()
        y = (x.float() - self.running_mean.float()) * mul + self.bias.float()
        return y.to(x.dtype)


class BatchNorm(nn.Module):
    """:class:`vit_cnn_tpu.nn.layers.BatchNorm`: torch defaults, with the
    statistics one level down (``bn``) as in the flax tree."""

    def __init__(self, features: int):
        super().__init__()
        self.bn = ChannelLastBatchNorm(features)

    def forward(self, x):
        return self.bn(x)


def max_pool_2x2(x):
    """flax ``nn.max_pool(x, (2, 2), strides=(2, 2))`` on NHWC (VALID:
    an odd last row/column is dropped, 7 -> 3)."""
    b, h, w, c = x.shape
    x = x[:, :h // 2 * 2, :w // 2 * 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def init_parameters(module: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter and statistic from one seeded generator, in
    module order (the counterpart of ``module.init`` with PRNGKey(seed);
    the values differ from jax.random's)."""
    g = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for m in module.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters(g)
    return module
