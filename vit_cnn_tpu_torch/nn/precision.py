"""Mixed-precision policies: the forward in bfloat16.

Port of :mod:`vit_cnn_tpu.nn.precision`. As there, the policy sits at the
apply boundary, inputs are cast to bfloat16, and logits come back in
float32.

* :func:`bf16_apply` (serving): every floating parameter and buffer is
  cast to bfloat16 in place (BatchNorm running statistics, ``A_log``,
  ``D`` and ``direction_gate`` included, as ``cast_floating`` does). The
  full-scene probability map accumulates in float32.
* :func:`bf16_train_apply` (training): the module is never changed. Each
  call casts a bfloat16 copy of every floating parameter inside the
  differentiated forward (``torch.func.functional_call``), so gradients
  arrive in float32 on the float32 master weights through the casts, and
  the BatchNorm statistics stay float32 buffers that train mode updates in
  place — the JAX step's ``cast_floating(params)`` with the batch stats
  passed in uncast (vit_cnn_tpu/train/loop.py).
"""

from __future__ import annotations

import torch
import torch.nn as nn


def _cast(x, dtype):
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x.to(dtype)
    if isinstance(x, tuple):
        return tuple(_cast(v, dtype) for v in x)
    return x


def bf16_apply(model: nn.Module):
    """Cast ``model`` to bfloat16 in place and return its forward with
    bf16 inputs and float32 outputs (tuples are mapped element-wise).
    ``Module.to(dtype)`` casts floating parameters and buffers only, so
    the int token-order tables stay as they are."""
    model.to(torch.bfloat16)

    def wrapped(*args):
        return _cast(model(*(_cast(a, torch.bfloat16) for a in args)),
                     torch.float32)

    return wrapped


def bf16_train_apply(model: nn.Module):
    """``model``'s forward on bfloat16 copies of its floating parameters
    and of the inputs, returning float32 outputs; ``model`` keeps its
    float32 parameters and buffers."""

    def wrapped(*args):
        params = {name: p.to(torch.bfloat16)
                  for name, p in model.named_parameters()
                  if p.is_floating_point()}
        out = torch.func.functional_call(
            model, params, tuple(_cast(a, torch.bfloat16) for a in args))
        return _cast(out, torch.float32)

    return wrapped
