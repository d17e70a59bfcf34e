"""Layers of the port (PyTorch counterparts of vit_cnn_tpu.nn)."""

from .mamba import MambaMixer  # noqa: F401
