"""Operand roundings for the references' products.

Each reference takes ``mm``, a function applied to both operands and to
the result of every matmul and convolution. ``None`` keeps float32 (the
reference); :func:`fp8` stores them in float8 with a per-tensor scale,
as an fp8 step does (products accumulated in float32): the control, one
precision below the bf16 that the configurations serve and train in,
where the program stores every product's inputs and output in bf16.
:func:`bf16` rounds them to bfloat16 the same way (values on the way
forward, gradients on the way back): not a control, but the program's
own rounding put into the reference, which shows how far bf16 alone
moves a number (``python -m gpubench.control --mode bf16``).
"""

from __future__ import annotations

import torch

#: the largest finite values of float8 e4m3fn (values) and e5m2 (gradients)
E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _round(x: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under the per-tensor scale that maps its
    largest magnitude to ``largest``, returned in float32."""
    with torch.no_grad():
        scale = x.abs().amax().float().clamp_min(1e-30) / largest
        return (x / scale).to(dtype).to(torch.float32) * scale


class _Fp8(torch.autograd.Function):
    """Values rounded to e4m3 on the way forward, gradients to e5m2 on the
    way back, as an fp8 training step stores them."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` in fp8: e4m3 under a per-tensor scale, in float32; under
    autograd its gradient is rounded to e5m2 the same way."""
    if x.requires_grad:
        return _Fp8.apply(x)
    return _round(x, torch.float8_e4m3fn, E4M3_MAX)


class _Bf16(torch.autograd.Function):
    """Values and gradients rounded to bfloat16, returned in float32."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(torch.float32)


def bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16, in float32; under autograd its gradient
    is rounded to bfloat16 too."""
    if x.requires_grad:
        return _Bf16.apply(x)
    return x.to(torch.bfloat16).to(torch.float32)


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


MODES = {"float32": identity, "fp8": fp8, "bf16": bf16}
