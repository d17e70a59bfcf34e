"""Determinism helper (counterpart of :mod:`vit_cnn_tpu.utils.seeding`,
ref: utils.py:887-895 seed_torch)."""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def seed_everything(seed: int) -> None:
    """Seed Python's ``random``, numpy's global RandomState and torch's
    generators (the CPU's and every CUDA card's)."""
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    torch.cuda.manual_seed_all(seed)
