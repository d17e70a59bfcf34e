"""Per-band min-max normalisation and NaN filtering of scene rasters (the
port's copy of :mod:`vit_cnn_tpu.data.normalize`, ref:
datasets.py:124-133 and 441-449). PCA (``apply_pca``, scikit-learn) is
left out with the PCA models."""

from __future__ import annotations

import numpy as np


def minmax_per_band(img: np.ndarray) -> np.ndarray:
    """Map each band of an (H, W, C) raster to [0, 1] independently. NaN
    pixels are skipped when finding the extrema, so one NaN pixel does not
    turn its whole band into NaN."""
    img = img.astype(np.float32, copy=True)
    flat = img.reshape(-1, img.shape[-1])
    minimal = np.nanmin(flat, axis=0)
    maximal = np.nanmax(flat, axis=0)
    scale = maximal - minimal
    scale[scale == 0] = 1.0
    return (img - minimal) / scale


def minmax_global(img: np.ndarray) -> np.ndarray:
    """Map the whole raster to [0, 1] with one min / max (single-band
    LiDAR)."""
    img = img.astype(np.float32, copy=True)
    minimal = np.nanmin(img)
    maximal = np.nanmax(img)
    scale = maximal - minimal
    if scale == 0:
        scale = 1.0
    return (img - minimal) / scale


def filter_nan(img1: np.ndarray, gt: np.ndarray
               ) -> tuple[np.ndarray, np.ndarray, bool]:
    """Zero the NaN pixels of the HSI cube and their labels. Returns
    (img1, gt, had_nan)."""
    nan_mask = np.isnan(img1.sum(axis=-1))
    had = bool(np.count_nonzero(nan_mask) > 0)
    if had:
        img1 = img1.copy()
        gt = gt.copy()
        img1[nan_mask] = 0
        gt[nan_mask] = 0
    return img1, gt, had
