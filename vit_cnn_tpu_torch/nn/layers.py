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

from ..ops._build import wide


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
    float32 statistics (float64 for float64 x) with the fast variance
    E[x^2] - E[x]^2 (clipped at 0), result in x's dtype. torch's own
    layer_norm takes the two-pass variance and differs in the last bits."""

    eps = 1e-6

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def reset_parameters(self, g: torch.Generator):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        f = wide(x)
        xf = x.to(f)
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight.to(f))
        return (y + self.bias.to(f)).to(x.dtype)


class ChannelLastBatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the last axis.

    Eval mode normalises with the running statistics. Train mode follows
    flax 0.12's defaults (``use_fast_variance``,
    ``force_float32_reductions``), not torch's ``F.batch_norm``: the
    float32 batch mean and the BIASED fast variance max(E[x^2] - E[x]^2, 0)
    over every axis but the last normalise the batch, and the running
    statistics become 0.9 * old + 0.1 * batch value with that same biased
    variance (torch would take the unbiased one). Statistics are float32
    (float64 for float64 x); the output is in x's dtype, and the running
    statistics keep their own dtype (float32 under the bf16 policies).
    ``zero_scale`` starts the scale at zero (NonLocal's output BN).
    """

    eps = 1e-5
    decay = 0.9          # flax momentum: the share of the old statistic

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
        f = wide(x)
        xf = x.to(f)
        if self.training:
            axes = tuple(range(x.dim() - 1))
            mean = xf.mean(dim=axes)
            var = ((xf * xf).mean(dim=axes) - mean * mean).clamp_min(0)
            with torch.no_grad():
                self.running_mean.copy_(self.decay * self.running_mean.to(f)
                                        + (1 - self.decay) * mean)
                self.running_var.copy_(self.decay * self.running_var.to(f)
                                       + (1 - self.decay) * var)
        else:
            mean, var = self.running_mean.to(f), self.running_var.to(f)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(f)
        y = (xf - mean) * mul + self.bias.to(f)
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
