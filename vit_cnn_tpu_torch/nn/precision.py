"""Mixed-precision policy: the forward in bfloat16.

Port of :mod:`vit_cnn_tpu.nn.precision`. As there, the policy sits at the
apply boundary: every floating parameter and buffer is cast to bfloat16
(BatchNorm running statistics, ``A_log``, ``D`` and ``direction_gate``
included, as ``cast_floating`` does), inputs are cast to bfloat16, and
logits come back in float32. The full-scene probability map accumulates
in float32.
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
