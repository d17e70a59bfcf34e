"""``--debug_nans``: stop at the first NaN a train step makes.

The JAX package sets ``jax_debug_nans``, which raises
``FloatingPointError`` when any jitted primitive produces a NaN (not an
infinity: that is ``jax_debug_infs``). The port's counterpart checks at
three places, each of which makes the host wait for the device, so it is
on only under the flag:

* the forward: :func:`watch` puts a hook on every submodule that raises
  ``FloatingPointError`` naming the module when a floating output holds
  a NaN;
* the backward: :func:`backward` runs it under
  ``torch.autograd.detect_anomaly(check_nan=True)`` and raises its NaN
  error as ``FloatingPointError``;
* the update: :func:`check_parameters` after each optimizer step.

The loss itself is held by :func:`check`.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn


def _has_nan(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_floating_point() and bool(torch.isnan(x).any())
    if isinstance(x, (tuple, list)):
        return any(_has_nan(v) for v in x)
    return False


def check(x, what: str) -> None:
    """Raise ``FloatingPointError`` when a floating tensor in ``x`` holds
    a NaN."""
    if _has_nan(x):
        raise FloatingPointError("NaN in {}".format(what))


def watch(model: nn.Module) -> List[torch.utils.hooks.RemovableHandle]:
    """Hook every module of ``model`` (itself included) to raise on a NaN
    in its output; returns the handles (``remove()`` each to stop)."""
    def hook(name):
        def fn(module, args, out):
            check(out, "the output of {} ({})".format(
                name or "the model", type(module).__name__))
        return fn

    return [m.register_forward_hook(hook(name))
            for name, m in model.named_modules()]


def backward(loss: torch.Tensor) -> None:
    """``loss.backward()`` under anomaly detection; a NaN in a gradient
    raises ``FloatingPointError`` naming the backward function."""
    with torch.autograd.detect_anomaly(check_nan=True):
        try:
            loss.backward()
        except RuntimeError as e:
            if "nan" not in str(e).lower():
                raise
            raise FloatingPointError(str(e)) from e


def check_parameters(model: nn.Module) -> None:
    """Raise ``FloatingPointError`` naming the first parameter holding a
    NaN."""
    for name, p in model.named_parameters():
        check(p, "parameter {}".format(name))
