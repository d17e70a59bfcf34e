"""Scenes and ground-truth splits (counterpart of vit_cnn_tpu.data).

The scenes come from the reference's dataset registry, which is numpy
only (no JAX): the port reads it here, in one place, so that callers name
only ``vit_cnn_tpu_torch``. The split is the port's own (``sampling``).
"""

from vit_cnn_tpu.data.registry import dataset_names, get_dataset
from vit_cnn_tpu.data.sampling import compute_imf_weights

__all__ = ["compute_imf_weights", "dataset_names", "get_dataset"]
