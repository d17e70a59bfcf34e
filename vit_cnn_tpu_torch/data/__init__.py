"""Scenes, ground-truth splits and class weights (counterpart of
vit_cnn_tpu.data, numpy only)."""

from .registry import dataset_names, get_dataset
from .sampling import compute_imf_weights

__all__ = ["compute_imf_weights", "dataset_names", "get_dataset"]
