"""Faults planted under the timed path, to show that ``correct`` catches
them (``tests/test_gpubench_faults.py``) and to read a training cell's
upper limits on the card (``python -m gpubench.control --mode
half_batch``).

A serving fault wraps the program's model (``Serve(fault=...)``); a
training fault patches the program's ``Trainer`` (``Train(fault=...)``).
"""

from __future__ import annotations

import torch.nn as nn


class _Wrapped(nn.Module):
    def __init__(self, inner: nn.Module, alter):
        super().__init__()
        self.inner, self.alter = inner, alter

    def forward(self, *args):
        return self.alter(self.inner(*args))


def half_windows(net: nn.Module) -> nn.Module:
    """Serving: half of every batch of windows left out (no logits)."""
    def alter(y):
        y = y.clone()
        y[y.shape[0] // 2:] = 0
        return y
    return _Wrapped(net, alter)


def one_window(net: nn.Module) -> nn.Module:
    """Serving: one window's answer of every batch altered where it is
    produced (its logits shifted by their largest magnitude)."""
    def alter(y):
        y = y.clone()
        y[0] = y[0] + y[0].abs().max()
        return y
    return _Wrapped(net, alter)


def half_batch(trainer) -> None:
    """Training: every step takes the first half of its batch and the
    mean over it; the other half is left out."""
    step = trainer._step

    def halved(centers, valid, loss_sum):
        half = centers.shape[0] // 2
        return step(centers[:half], valid[:half], loss_sum)
    trainer._step = halved


def unchanged(trainer) -> None:
    """Training: a step that returns the parameters as they were (the
    optimizer computes its update, which is then dropped)."""
    step = trainer.optimizer.step
    params = list(trainer.model.parameters())

    def dropped(*args, **kwargs):
        kept = [p.detach().clone() for p in params]
        step(*args, **kwargs)
        for p, k in zip(params, kept):
            p.data.copy_(k)
    trainer.optimizer.step = dropped


SERVE = {"half_windows": half_windows, "one_window": one_window}
TRAIN = {"half_batch": half_batch, "unchanged": unchanged}
