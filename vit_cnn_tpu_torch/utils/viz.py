"""Artifact writer: the run's maps, curves and reports as files.

Counterpart of :class:`vit_cnn_tpu.utils.viz.ArtifactWriter` (the
reference's Visdom surface, ref: main.py:306-340, utils.py:169-270). The
same calls write the same file names into the same directory; the GPU
host has neither PIL nor matplotlib, so the images are made here:

* PNGs come from :func:`write_png` (``zlib`` and ``struct``): 8-bit
  grayscale, RGB or RGBA, filter type 0. Arrays that are not uint8 are
  scaled to 0-255 exactly as the JAX writer scales them, so a map or a
  composite has the same pixels as the JAX writer's (PIL) file; the
  compressed bytes differ. :func:`read_png` reads these files back.
* ``confusion_matrix[_run{r}].png`` is the heatmap alone: each cell a
  square block of pixels, colored by viridis (17 anchors of matplotlib's
  table, linearly interpolated) from the matrix's min to its max. The
  JAX figure's axes, labels and colorbar are not drawn.
* ``explore_spectrums`` returns the same dict of per-class mean spectra,
  and writes the curves' numbers (each class's mean and std per band) as
  ``mean_spectrums.json`` in place of the JAX ``mean_spectrums.png``.

Under a mesh only rank 0 writes: the other ranks' writers are made with
``enabled=False``, and every call of theirs writes nothing and returns
None.
"""

from __future__ import annotations

import functools
import json
import os
import struct
import time
import zlib
from typing import Dict, Optional, Sequence

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {1: 0, 3: 2, 4: 6}          # channels -> PNG color type
# matplotlib's viridis at 0, 1/16, ..., 1
_VIRIDIS = np.array([
    (0.2670, 0.0049, 0.3294), (0.2823, 0.0950, 0.4173),
    (0.2788, 0.1755, 0.4834), (0.2590, 0.2515, 0.5247),
    (0.2297, 0.3224, 0.5457), (0.1994, 0.3876, 0.5546),
    (0.1727, 0.4488, 0.5579), (0.1490, 0.5081, 0.5573),
    (0.1276, 0.5669, 0.5506), (0.1206, 0.6258, 0.5335),
    (0.1579, 0.6838, 0.5017), (0.2461, 0.7389, 0.4520),
    (0.3692, 0.7889, 0.3829), (0.5160, 0.8312, 0.2943),
    (0.6785, 0.8637, 0.1895), (0.8456, 0.8873, 0.0997),
    (0.9932, 0.9062, 0.1439)])
_HEATMAP_PIXELS = 480                      # side of the heatmap, about


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xffffffff))


def write_png(path: str, arr: np.ndarray) -> None:
    """Write a uint8 (H, W), (H, W, 3) or (H, W, 4) array as a PNG."""
    arr = np.asarray(arr)
    channels = 1 if arr.ndim == 2 else arr.shape[-1]
    if arr.dtype != np.uint8 or arr.ndim not in (2, 3) or \
            channels not in _COLOR_TYPES:
        raise ValueError("write_png takes uint8 (H, W), (H, W, 3) or (H, W, "
                         "4), not {} {}".format(arr.dtype, arr.shape))
    h, w = arr.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(arr).reshape(h, -1)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[channels], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Read a PNG that :func:`write_png` wrote: 8-bit grayscale, RGB or
    RGBA, not interlaced, every row of filter type 0. Returns (H, W) or
    (H, W, C) uint8; raises on anything else."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError("{}: not a PNG".format(path))
    pos, header, idat = len(_PNG_SIGNATURE), None, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(tag + body) & 0xffffffff != crc:
            raise ValueError("{}: bad CRC in {}".format(path, tag))
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("{}: no IHDR".format(path))
    w, h, depth, color, _, _, interlace = header
    channels = {v: k for k, v in _COLOR_TYPES.items()}.get(color)
    if depth != 8 or channels is None or interlace:
        raise ValueError("{}: only 8-bit gray / RGB / RGBA, not interlaced, "
                         "is read (depth {}, color type {})".format(
                             path, depth, color))
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, 1 + w * channels)
    if rows[:, 0].any():
        raise ValueError("{}: rows with filters other than 0".format(path))
    out = rows[:, 1:].reshape(h, w, channels)
    return out[..., 0] if channels == 1 else out


def _save_png(path: str, arr: np.ndarray) -> None:
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        lo, hi = float(np.nanmin(arr)), float(np.nanmax(arr))
        arr = ((arr - lo) / max(hi - lo, 1e-12) * 255).astype(np.uint8)
    write_png(path, arr)


def heatmap(matrix: np.ndarray, cell: Optional[int] = None) -> np.ndarray:
    """(K, K) values -> a uint8 RGB image of viridis cells, min to max."""
    m = np.asarray(matrix, dtype=np.float64)
    lo, hi = float(m.min()), float(m.max())
    x = (m - lo) / (hi - lo) if hi > lo else np.zeros_like(m)
    anchors = np.linspace(0.0, 1.0, len(_VIRIDIS))
    rgb = np.stack([np.interp(x, anchors, _VIRIDIS[:, c]) for c in range(3)],
                   axis=-1)
    cell = cell or max(1, _HEATMAP_PIXELS // max(m.shape))
    rgb = np.repeat(np.repeat(rgb, cell, axis=0), cell, axis=1)
    return np.round(255 * rgb).astype(np.uint8)


def _writes(method):
    """A writing method of :class:`ArtifactWriter`: nothing when the
    writer is not enabled."""
    @functools.wraps(method)
    def wrapped(self, *args, **kwargs):
        return method(self, *args, **kwargs) if self.enabled else None
    return wrapped


class ArtifactWriter:
    """Writes the reference's Visdom surface to ``<out_dir>/``; with
    ``enabled`` False (a mesh rank other than 0), nothing."""

    def __init__(self, out_dir: str = "./results/artifacts",
                 enabled: bool = True):
        self.out_dir = out_dir
        self.enabled = enabled
        if enabled:
            os.makedirs(out_dir, exist_ok=True)
        self._metrics_path = os.path.join(out_dir, "metrics.jsonl")

    # -- scalar stream (loss / val-acc curves; ref: model_utils.py:940-974)
    @_writes
    def log_scalars(self, step: int, scalars: Dict[str, float],
                    run: Optional[int] = None) -> None:
        rec = {"ts": time.time(), "step": step, **scalars}
        if run is not None:
            rec["run"] = run
        with open(self._metrics_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    # -- dataset RGB composite (ref: utils.py:169-186 display_dataset)
    @_writes
    def save_dataset_rgb(self, img: np.ndarray,
                         rgb_bands: Sequence[int]) -> None:
        rgb = np.stack([img[..., b] for b in rgb_bands], axis=-1)
        rgb = (255.0 * np.clip(rgb, 0.0, 1.0)).astype(np.uint8)
        _save_png(os.path.join(self.out_dir, "dataset_rgb.png"), rgb)

    # -- LiDAR grayscale (ref: utils.py:189-198 display_lidar_data)
    @_writes
    def save_lidar(self, img: np.ndarray) -> None:
        _save_png(os.path.join(self.out_dir, "lidar.png"), img[..., 0])

    # -- GT / prediction color maps (ref: utils.py display_predictions)
    @_writes
    def save_map(self, color_map: np.ndarray, caption: str,
                 run: Optional[int] = None) -> None:
        name = caption.replace(" ", "_").replace(":", "").replace("/", "-")
        if run is not None:
            name = "{}_run{}".format(name, run)
        _save_png(os.path.join(self.out_dir, name + ".png"), color_map)

    # -- per-class mean spectra (ref: utils.py:218-270 explore_spectrums)
    @_writes
    def explore_spectrums(self, img: np.ndarray, gt: np.ndarray,
                          label_values: Sequence[str],
                          ignored_labels: Sequence[int] = (0,)
                          ) -> Dict[str, np.ndarray]:
        mean_spectrums, curves = {}, {}
        for c in np.unique(gt):
            if c in ignored_labels:
                continue
            spectrums = img[gt == c].reshape(-1, img.shape[-1])
            mean = np.mean(spectrums, axis=0)
            std = np.std(spectrums, axis=0)
            mean_spectrums[label_values[c]] = mean
            curves[label_values[c]] = {"mean": mean.tolist(),
                                       "std": std.tolist()}
        with open(os.path.join(self.out_dir, "mean_spectrums.json"),
                  "w") as f:
            json.dump(curves, f)
        return mean_spectrums

    # -- confusion-matrix heatmap (ref: utils.py:676-684)
    @_writes
    def save_confusion_matrix(self, cm: np.ndarray,
                              run: Optional[int] = None) -> None:
        name = "confusion_matrix" if run is None else \
            "confusion_matrix_run{}".format(run)
        write_png(os.path.join(self.out_dir, name + ".png"), heatmap(cm))

    # -- feature-map viz (ref: model_utils.py:661-679 show_featuremap:
    #    first sample of a (B, C, H, W) activation as an RGB composite)
    @_writes
    def show_featuremap(self, name: str, fm: np.ndarray,
                        rgb_bands: Sequence[int] = (0, 1, 2)) -> None:
        fm = np.asarray(fm)[0]                        # first sample
        if fm.ndim == 3 and fm.shape[-1] >= fm.shape[0]:
            fm = fm.transpose(1, 2, 0)                # (C, H, W) -> HWC
        bands = [min(b, fm.shape[-1] - 1) for b in rgb_bands]
        rgb = np.stack([fm[..., b] for b in bands], axis=-1)
        _save_png(os.path.join(self.out_dir,
                               "featuremap_{}.png".format(name)), rgb)

    # -- text report (mirrors what show_results prints)
    @_writes
    def save_report(self, text: str, name: str = "report.txt") -> None:
        with open(os.path.join(self.out_dir, name), "a") as f:
            f.write(text + "\n")
