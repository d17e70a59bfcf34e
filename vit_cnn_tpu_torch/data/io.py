"""File IO for remote-sensing rasters (the port's copy of
:mod:`vit_cnn_tpu.data.io`, ref: utils.py:109-122): .mat through
scipy.io.loadmat, .npy / .npz natively, .tif through imageio and .hdr
through spectral where those are installed."""

from __future__ import annotations

import os
from typing import Any

import numpy as np


def open_file(path: str) -> Any:
    """Open a dataset file: the loadmat dict for ``.mat``, the array for
    ``.npy``, the archive for ``.npz``."""
    _, ext = os.path.splitext(path)
    ext = ext.lower()
    if ext == ".mat":
        from scipy import io as scipy_io

        return scipy_io.loadmat(path)
    if ext in (".npy", ".npz"):
        return np.load(path)
    if ext in (".tif", ".tiff"):
        import imageio.v2 as imageio

        return imageio.imread(path)
    if ext == ".hdr":
        import spectral

        return spectral.open_image(path).load()
    raise ValueError("Unknown file format: {}".format(ext))


def load_mat_key(path: str, key: str) -> np.ndarray:
    """Load one variable from a .mat file."""
    return open_file(path)[key]
