"""Eval-mode BatchNorm over the last axis, with the conv bias before it and
the ReLU after it, as one elementwise pass.

* :func:`bn_act_reference` — the plain PyTorch chain of
  :class:`..nn.layers.ChannelLastBatchNorm` in eval mode: the conv's bias
  added in x's dtype (as cuDNN's route adds it, after the conv), x widened
  to float32 (float64 for float64 x), ``(x - mean) * (rsqrt(var + eps) *
  weight) + bias``, the result in x's dtype, then ``relu``.
  :func:`normalize` is its tail, which train mode runs on the batch's
  statistics.
* :func:`bn_act` — the kernel (``csrc/bn_act.cu``) where :func:`engages`,
  else the plain version. The kernel replaces no TPU kernel (the JAX
  package leaves the chain to XLA); on the card it reads x once and
  writes y once, where the plain chain's kernels move ~44 bytes an element
  of a bf16 tensor, and repeats the chain's arithmetic rounding by
  rounding, so the two are equal bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build


def normalize(xf, mean, var, weight, bias, eps: float, dtype: torch.dtype,
              relu: bool = False):
    """``(xf - mean) * (rsqrt(var + eps) * weight) + bias`` in xf's float
    dtype (mean and var in it too), cast to ``dtype``, then ReLU."""
    f = xf.dtype
    mul = torch.rsqrt(var + eps) * weight.to(f)
    y = ((xf - mean) * mul + bias.to(f)).to(dtype)
    return F.relu(y) if relu else y


def bn_act_reference(x, mean, var, weight, bias, eps: float, conv_bias=None,
                     relu: bool = False):
    """x (..., C) normalised with the statistics ``mean`` and ``var`` (C,),
    after ``conv_bias`` (C,) where given and before a ReLU where asked."""
    if conv_bias is not None:
        x = x + conv_bias
    f = _build.wide(x)
    return normalize(x.to(f), mean.to(f), var.to(f), weight, bias, eps,
                     x.dtype, relu)


def engages(x, *tensors) -> bool:
    """Whether an eval-mode BatchNorm of x with the per-channel ``tensors``
    (None for one absent) takes the kernel: x on CUDA in float32 or
    bfloat16, every tensor on its device in its dtype, and no gradient
    wanted (grad mode off, or nothing requires one). Train mode, autograd,
    float64, mixed dtypes and the CPU keep the plain chain."""
    given = [t for t in tensors if t is not None]
    return (x.is_cuda and x.dtype in _build.DTYPE_CODES
            and all(t.device == x.device and t.dtype == x.dtype
                    for t in given)
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in [x, *given])))


def _kernel(x, mean, var, weight, bias, eps, conv_bias, relu):
    x = x.contiguous()
    vectors = [t.contiguous() for t in (mean, var, weight, bias)]
    c = x.shape[-1]
    if any(t.shape != (c,) for t in vectors) or (
            conv_bias is not None and conv_bias.shape != (c,)):
        raise ValueError("per-channel vectors must be ({},)".format(c))
    if conv_bias is not None:
        conv_bias = conv_bias.contiguous()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = _build.lib().vct_bn_act(
            _build.dtype_code(x), x.data_ptr(), y.data_ptr(), x.numel(), c,
            *(t.data_ptr() for t in vectors),
            None if conv_bias is None else conv_bias.data_ptr(),
            float(eps), int(relu), _build.stream_of(x))
    _build.check("bn_act", code)
    _build.launches["bn_act"] += 1
    return y


def bn_act(x, mean, var, weight, bias, eps: float, conv_bias=None,
           relu: bool = False):
    """Eval-mode BatchNorm of x (..., C) with the running statistics
    ``mean`` and ``var``: :func:`bn_act_reference`'s result, by the kernel
    where :func:`engages` (a non-contiguous x is made contiguous first),
    else by the plain chain."""
    if engages(x, mean, var, weight, bias, conv_bias):
        return _kernel(x, mean, var, weight, bias, eps, conv_bias, relu)
    return bn_act_reference(x, mean, var, weight, bias, eps, conv_bias, relu)
