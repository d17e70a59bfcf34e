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

from ..ops import bn_act, bn_train
from ..ops._build import wide
from ..parallel import mesh


def _lecun_normal_(w: torch.Tensor, fan_in: int, g: torch.Generator):
    """flax's lecun_normal: truncated normal (+-2 sd) of variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)


#: flax's variance_scaling initializers by name: (scale, fan, distribution)
INITS = {"lecun_normal": (1.0, "in", "truncated"),
         "kaiming_out": (2.0, "out", "normal"),     # torch kaiming fan_out
         "kaiming_in": (2.0, "in", "normal"),
         "xavier_uniform": (1.0, "avg", "uniform"),
         "xavier_normal": (1.0, "avg", "truncated")}


def init_weight_(w: torch.Tensor, init: str, g: torch.Generator):
    """Fill a Dense (out, in) or conv (out, in / groups, *k) weight from
    ``INITS[init]`` with the fans flax computes for the same kernel."""
    scale, fan, dist = INITS[init]
    rf = w[0, 0].numel()
    fan_in, fan_out = w.shape[1] * rf, w.shape[0] * rf
    n = {"in": fan_in, "out": fan_out, "avg": (fan_in + fan_out) / 2}[fan]
    std = math.sqrt(scale / n)
    if dist == "uniform":
        bound = math.sqrt(3.0) * std
        nn.init.uniform_(w, -bound, bound, generator=g)
    elif dist == "normal":
        nn.init.normal_(w, 0.0, std, generator=g)
    else:
        std /= 0.87962566103423978
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)


class Dense(nn.Module):
    """flax ``nn.Dense``: y = x W^T + b with W (out, in)."""

    flax_kernel = "dense"    # convert.py: (in, out) <-> (out, in)

    def __init__(self, in_features: int, out_features: int,
                 use_bias: bool = True, init: str = "lecun_normal",
                 bias_std: float = 0.0):
        super().__init__()
        self.init, self.bias_std = init, bias_std
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = (nn.Parameter(torch.empty(out_features)) if use_bias
                     else None)

    def reset_parameters(self, g: torch.Generator):
        init_weight_(self.weight, self.init, g)
        if self.bias is not None:
            nn.init.normal_(self.bias, 0.0, self.bias_std, generator=g) \
                if self.bias_std else nn.init.zeros_(self.bias)

    def forward(self, x):
        w, b = self.weight, self.bias
        if x.dtype != w.dtype:
            # flax promotes the input and the parameters to one dtype (a
            # float32 input under the bf16 policy computes in float32)
            f = torch.promote_types(x.dtype, w.dtype)
            x, w = x.to(f), w.to(f)
            b = None if b is None else b.to(f)
        return F.linear(x, w, b)


def _per_dim(v, nd: int) -> tuple:
    return (int(v),) * nd if isinstance(v, int) else tuple(int(x) for x in v)


class Conv(nn.Module):
    """flax ``nn.Conv`` on channel-last input with 1, 2 or 3 spatial dims
    (NWC, NHWC, NDHWC; ``kernel`` an int is a square 2-D kernel). Weight
    (out, in / groups, *kernel); symmetric zero ``padding`` per spatial
    dim (flax's ``padding=p`` or ``((p, p), ...)``), ``strides`` and
    ``groups`` (flax ``feature_group_count``). VALID by default.
    ``init`` names the kernel's initializer (:data:`INITS`)."""

    flax_kernel = "conv"     # convert.py: (*k, in/g, out) <-> (out, in/g, *k)

    def __init__(self, in_features: int, out_features: int, kernel=1,
                 strides=1, padding=0, groups: int = 1,
                 use_bias: bool = True, init: str = "lecun_normal"):
        super().__init__()
        kernel = (kernel, kernel) if isinstance(kernel, int) else tuple(kernel)
        if in_features % groups or out_features % groups:
            raise ValueError("{} -> {} channels do not split into {} groups"
                             .format(in_features, out_features, groups))
        self.strides = _per_dim(strides, len(kernel))
        self.padding = _per_dim(padding, len(kernel))
        self.groups, self.init = groups, init
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features // groups, *kernel))
        self.bias = (nn.Parameter(torch.empty(out_features)) if use_bias
                     else None)

    def reset_parameters(self, g: torch.Generator):
        init_weight_(self.weight, self.init, g)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    @property
    def pointwise(self) -> bool:
        """A 1x1 conv at stride 1, unpadded and ungrouped: one matmul over
        the channels, its bias added by cuBLAS."""
        return (self.weight[0, 0].numel() == 1 and self.groups == 1
                and not any(self.padding) and set(self.strides) == {1})

    def forward(self, x, with_bias: bool = True):
        """``with_bias`` False leaves the bias out (for a caller that adds
        it itself)."""
        nd = self.weight.dim() - 2
        bias = self.bias if with_bias else None
        if self.pointwise:
            return F.linear(x, self.weight.reshape(self.weight.shape[:2]),
                            bias)
        conv = (F.conv1d, F.conv2d, F.conv3d)[nd - 1]
        x, padding = x.movedim(-1, 1), self.padding
        if (nd == 3 and x.device.type == "cpu" and any(padding)
                and (max(self.strides) > 1 or x.dtype == torch.bfloat16)):
            # torch 2.13.0 (CPU, oneDNN v3.12.0) gets the weight gradient of
            # a padded 3-D conv wrong in two cases. Strided (float32):
            # x (2, 1, 8, 1, 1), w (16, 1, 11, 1, 1), stride (3, 1, 1),
            # padding (5, 0, 0) corrupts the heap, w.grad of the sum aborts
            # or segfaults within 50 calls (MHST's stem over 7-8 bands).
            # bf16 at stride 1: x (1, 16, 2, 1, 1), w (1, 16, 3, 1, 1),
            # padding (1, 0, 0) gives a garbage or NaN w.grad on every
            # call (16+ input channels and a kernel deeper than the input:
            # MHST's band inception over 3 depths). Padded explicitly,
            # neither fails. Drop this branch once both cases pass
            # (tests/test_torch_cnn_zoo_train.py holds the second).
            x = F.pad(x, [p for p in reversed(padding) for _ in (0, 1)])
            padding = 0
        y = conv(x, self.weight, bias, self.strides, padding, 1, self.groups)
        return y.movedim(1, -1)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: float32 statistics (float64 for float64 x)
    with the fast variance E[x^2] - E[x]^2 (clipped at 0), result in x's
    dtype. torch's own layer_norm takes the two-pass variance and differs
    in the last bits. ``eps`` defaults to flax's 1e-6 (every LN of the
    flagship); the ViT backbone and MHST use 1e-5."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
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
    ``zero_scale`` starts the scale at zero (NonLocal's output BN). A
    subclass with ``updates_statistics`` False normalises a train-mode
    batch with its statistics and leaves the running ones as they are.
    Under an engaged mesh (:mod:`..parallel.mesh`) the statistics are the
    global batch's, as in the JAX step's one program over the sharded
    batch: sum(x), sum(x^2) and the count summed over the ranks (not
    torch's ``SyncBatchNorm``, whose running variance is the unbiased
    one); the running statistics come out equal on every rank.
    """

    eps = 1e-5
    decay = 0.9          # flax momentum: the share of the old statistic
    updates_statistics = True

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

    def forward(self, x, conv_bias=None, relu: bool = False):
        """BatchNorm of x, before a ReLU where asked. Eval mode is
        :func:`..ops.bn_act.bn_act`: one kernel on the card where it
        engages, the plain chain otherwise; it also takes ``conv_bias``
        (the preceding conv's bias, added in x's dtype), which a train-mode
        conv keeps. Train mode is :func:`..ops.bn_train.bn_train` (four
        kernels a forward and backward) on the card in float32 and
        bfloat16, and the plain chain below on the CPU and in float64."""
        if not self.training:
            return bn_act.bn_act(x, self.running_mean, self.running_var,
                                 self.weight, self.bias, self.eps,
                                 conv_bias, relu)
        assert conv_bias is None, "train mode: the conv adds its own bias"
        if bn_train.engages(x):
            return bn_train.bn_train(x, self.weight, self.bias,
                                     self.running_mean, self.running_var,
                                     self.eps, self.decay, relu,
                                     self.updates_statistics)
        f = wide(x)
        xf = x.to(f)
        axes = tuple(range(x.dim() - 1))
        if mesh.current() is None:
            mean = xf.mean(dim=axes)
            var = ((xf * xf).mean(dim=axes) - mean * mean).clamp_min(0)
        else:
            # the global batch's statistics: the sums of x and x^2 and
            # the count, summed over the ranks (one differentiable
            # all-reduce; the fast variance needs no second one)
            c = x.shape[-1]
            count = torch.full((1,), float(xf.numel() // max(c, 1)),
                               dtype=f, device=x.device)
            sums = mesh.global_sum(torch.cat([
                xf.sum(dim=axes), (xf * xf).sum(dim=axes), count]))
            mean = sums[:c] / sums[-1]
            var = (sums[c:2 * c] / sums[-1] - mean * mean).clamp_min(0)
        if self.updates_statistics:
            with torch.no_grad():
                self.running_mean.copy_(
                    self.decay * self.running_mean.to(f)
                    + (1 - self.decay) * mean)
                self.running_var.copy_(
                    self.decay * self.running_var.to(f)
                    + (1 - self.decay) * var)
        return bn_act.normalize(xf, mean, var, self.weight, self.bias,
                                self.eps, x.dtype, relu)


class BatchNorm(nn.Module):
    """:class:`vit_cnn_tpu.nn.layers.BatchNorm`: torch defaults, with the
    statistics one level down (``bn``) as in the flax tree."""

    def __init__(self, features: int):
        super().__init__()
        self.bn = ChannelLastBatchNorm(features)

    def forward(self, x, conv_bias=None, relu: bool = False):
        return self.bn(x, conv_bias, relu)


def gelu(x):
    """flax ``nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def max_pool_2x2(x):
    """flax ``nn.max_pool(x, (2, 2), strides=(2, 2))`` on NHWC (VALID:
    an odd last row/column is dropped, 7 -> 3, 11 -> 5)."""
    b, h, w, c = x.shape
    x = x[:, :h // 2 * 2, :w // 2 * 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def max_pool_same(x):
    """:func:`vit_cnn_tpu.nn.layers.max_pool_same`: torch's MaxPool2d(2,
    stride 2, padding 1) on NHWC, the padding -inf (7 -> 4 -> 3)."""
    return F.max_pool2d(x.movedim(-1, 1), 2, 2, 1).movedim(1, -1)


def adaptive_avg_pool(x):
    """AdaptiveAvgPool2d(1): (B, H, W, C) -> (B, C)."""
    return x.mean(dim=(1, 2))


class ConvBNReLU(nn.Module):
    """:class:`vit_cnn_tpu.nn.layers.ConvBNReLU`: Conv2d (kaiming fan_out
    init) -> BatchNorm (torch defaults) -> ReLU, NHWC. ``padding`` is an
    int (symmetric) or "SAME" (stride 1, odd kernel: kernel // 2)."""

    def __init__(self, in_features: int, features: int, kernel=(3, 3),
                 padding="SAME", use_bias: bool = True):
        super().__init__()
        kernel = _per_dim(kernel, 2)
        if padding == "SAME":
            if any(k % 2 == 0 for k in kernel):
                raise ValueError("SAME padding of an even kernel {}"
                                 .format(kernel))
            padding = tuple(k // 2 for k in kernel)
        self.Conv_0 = Conv(in_features, features, kernel, padding=padding,
                           use_bias=use_bias, init="kaiming_out")
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x):
        conv, bn = self.Conv_0, self.BatchNorm_0
        if (not bn.training and conv.bias is not None and not conv.pointwise
                and bn_act.engages(x, conv.weight, conv.bias)):
            # cuDNN's route adds the bias after the conv, in x's dtype: the
            # BatchNorm pass adds it the same way, in the same read (and
            # the CPU's conv, which may add it inside, keeps it)
            return bn(conv(x, with_bias=False), conv.bias, relu=True)
        return bn(conv(x), relu=True)


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
