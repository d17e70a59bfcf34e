"""Per-band min-max normalisation and NaN filtering of scene rasters (the
port's copy of :mod:`vit_cnn_tpu.data.normalize`, ref:
datasets.py:124-133 and 441-449) and the whitened PCA of the PCA models
(``apply_pca``, in numpy: the GPU host has no scikit-learn)."""

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


def apply_pca(img: np.ndarray, num_components: int) -> np.ndarray:
    """Per-pixel whitened PCA over the bands (ref: utils.py:85-93): what
    ``sklearn.decomposition.PCA(num_components, whiten=True)
    .fit_transform`` gives on the (H*W, bands) pixels with its
    ``covariance_eigh`` solver, computed in float64 and returned float32.

    The covariance of the centred pixels (divided by n - 1) is
    eigendecomposed, the components ordered by falling eigenvalue (those
    below 0 clipped to 0), each component's sign set so that its entry of
    largest magnitude is positive (scikit-learn's ``svd_flip`` with
    ``u_based_decision=False``), and the projections divided by
    sqrt(eigenvalue), floored at float64's eps."""
    h, w, c = img.shape
    if not 0 < num_components <= min(h * w, c):
        raise ValueError("{} PCA components of {} pixels of {} bands".format(
            num_components, h * w, c))
    flat = img.reshape(-1, c).astype(np.float64)
    centred = flat - flat.mean(axis=0)
    cov = centred.T @ centred / (len(flat) - 1)
    values, vectors = np.linalg.eigh(cov)
    values = np.maximum(values[::-1][:num_components], 0.0)
    comps = vectors[:, ::-1][:, :num_components].T          # (k, c)
    rows = np.arange(num_components)
    comps *= np.sign(comps[rows, np.abs(comps).argmax(axis=1)])[:, None]
    scale = np.maximum(np.sqrt(values), np.finfo(np.float64).eps)
    out = centred @ comps.T / scale
    return out.reshape(h, w, num_components).astype(np.float32)


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
