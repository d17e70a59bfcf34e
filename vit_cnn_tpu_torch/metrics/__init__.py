"""Classification metrics (counterpart of vit_cnn_tpu.metrics)."""

from .classification import confusion, metrics

__all__ = ["confusion", "metrics"]
