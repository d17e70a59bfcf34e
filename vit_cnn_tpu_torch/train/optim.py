"""Optimizers and the StepLR schedule.

Port of :mod:`vit_cnn_tpu.train.optim`. ``adam`` is torch Adam (L2 added
to the gradient, optax ``add_decayed_weights`` + ``scale_by_adam``);
``adamw`` is torch AdamW with decoupled weight decay (0.01 when none is
given), which equals ``optax.adamw`` with eps 1e-8. The learning rate
follows StepLR(step_size epochs, gamma) stepped per epoch and counted in
optimizer steps: lr(step) = lr * gamma^((step // steps_per_epoch) //
step_size), where step counts the updates already made (optax's count).
``sgd`` comes with the zoo models that use it (ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    name: str = "adam"          # adam | adamw
    lr: float = 1e-3
    weight_decay: float = 0.0   # adam: L2-into-grad; adamw: decoupled
    step_size: Optional[int] = 30
    gamma: float = 0.9


def build_lr_schedule(spec: OptimizerSpec,
                      steps_per_epoch: int) -> Callable[[int], float]:
    """lr(step); constant when ``step_size`` is None."""
    def schedule(step: int) -> float:
        if spec.step_size is None:
            return spec.lr
        epoch = step // max(steps_per_epoch, 1)
        return spec.lr * (spec.gamma ** (epoch // spec.step_size))

    return schedule


def build_optimizer(spec: OptimizerSpec, params) -> torch.optim.Optimizer:
    if spec.name == "adam":
        return torch.optim.Adam(params, lr=spec.lr, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=spec.weight_decay)
    if spec.name == "adamw":
        return torch.optim.AdamW(params, lr=spec.lr, betas=(0.9, 0.999),
                                 eps=1e-8,
                                 weight_decay=spec.weight_decay or 0.01)
    if spec.name == "sgd":
        raise NotImplementedError(
            "sgd is not ported yet: it comes with the zoo models that use "
            "it (ROADMAP Queue 1, 'training: sgd')")
    raise ValueError("unknown optimizer {}".format(spec.name))
