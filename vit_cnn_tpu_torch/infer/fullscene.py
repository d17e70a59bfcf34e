"""Full-scene sliding-window inference.

Port of :mod:`vit_cnn_tpu.infer.fullscene`. The scene stays on the
device, and each window's logits add into its center pixel of an
(H, W, K) float32 map; border pixels receive no probability mass (ref:
model_utils.py:1127-1131).

* Stride 1: every (H-P+1) x (W-P+1) window origin is visited row-major,
  a band of ``rows`` origin rows at a time: the band's windows are P*P
  static slices of a (rows+P-1)-row strip (``band_patches``), the model
  runs on the whole band, and the logits add into the map with one
  contiguous slice add.
* Stride > 1: the generic per-origin path (:func:`per_origin_map`), the
  origins of :func:`sliding_window_origins` a chunk at a time, gathered
  by :func:`gather_windows` and scattered into the map by an
  accumulating index add.

A PCA model's HSI is reduced on the host once per scene and kept PCA'd
in the :class:`SceneCache` (the JAX package reduces it again on every
request).

Under a mesh (:mod:`..parallel.mesh`, every rank calling with the same
scene) the work splits as the JAX package splits it, with no
communication until the end: at stride 1 the bands go in groups of
``rows * n`` origin rows (the scene padded to a multiple of that), rank r
taking band r of each group; at stride > 1 rank r takes every n-th
chunk of origins. Each rank adds its windows into a zero-filled map and
one all-reduce sums the maps: every pixel gets its windows from one rank
only, so the sum is the world-size-1 map.

While a profiler runs, the map, a scene's upload, each band or chunk and
the map's download are named ranges (:data:`MAP_SPAN` and the others
below, :func:`..utils.profiling.span`).
"""

from __future__ import annotations

import weakref
from typing import Dict, Optional

import numpy as np
import torch

from ..data.normalize import apply_pca
from ..nn.precision import bf16_apply
from ..parallel.mesh import Mesh
from ..utils.profiling import span

#: profiler ranges: one whole map, a scene's upload on a cache miss, one
#: band of the stride-1 loop, one chunk of the per-origin path, and the
#: map's download to the host
MAP_SPAN = "fullscene.map"
UPLOAD_SPAN = "fullscene.upload"
BAND_SPAN = "fullscene.band"
CHUNK_SPAN = "fullscene.chunk"
DOWNLOAD_SPAN = "fullscene.download"


class SceneCache:
    """Device-resident scenes, so a repeated request on a scene skips its
    upload. Keyed by the id() of the host array with a weakref finalizer
    (the entry goes when the caller drops the array); a host array
    mutated in place is not re-uploaded. A PCA model's scene is cached
    PCA'd, per component count, under its host array's entry, so it goes
    with the scene. On the CPU the cached tensor aliases the host array
    (or its PCA) and keeps its entry alive until :meth:`drop`."""

    def __init__(self):
        self._entries: Dict[int, tuple] = {}
        self.uploads = 0

    def get(self, img, dtype: torch.dtype, device,
            pca: int = 0) -> torch.Tensor:
        """The scene on ``device`` in ``dtype``; with ``pca`` > 0 its
        whitened PCA to that many components (:func:`..data.normalize.
        apply_pca`), computed once."""
        base = img if isinstance(img, np.ndarray) else np.asarray(img)
        entry = self._entries.get(id(base))
        if entry is None or entry[0]() is not base:
            ref = weakref.ref(base, lambda r, k=id(base), d=self._entries:
                              d.pop(k, None))
            entry = (ref, {})
            self._entries[id(base)] = entry
        key = (str(device), dtype, pca)
        if key not in entry[1]:
            with span(UPLOAD_SPAN):
                host = apply_pca(base, pca) if pca else base
                host = torch.from_numpy(np.ascontiguousarray(host,
                                                             np.float32))
                entry[1][key] = host.to(device).to(dtype)
            self.uploads += 1
        return entry[1][key]

    def drop(self, img) -> None:
        """Forget the device copies of a host array (whose owner lets it
        go; on the CPU the weakref alone would never fire)."""
        base = img if isinstance(img, np.ndarray) else np.asarray(img)
        entry = self._entries.get(id(base))
        if entry is not None and entry[0]() is base:
            del self._entries[id(base)]


def sliding_window_origins(h: int, w: int, patch_size: int,
                           step: int = 1) -> np.ndarray:
    """(N, 2) window origins replicating ref: utils.py:357-401 ordering and
    the clamp-to-edge duplicates when stride does not divide the span."""
    p = patch_size
    offset_h = (h - p) % step
    offset_w = (w - p) % step
    xs = np.arange(0, h - p + offset_h + 1, step)
    xs = np.minimum(xs, h - p)
    ys = np.arange(0, w - p + offset_w + 1, step)
    ys = np.minimum(ys, w - p)
    xx = np.repeat(xs, len(ys))
    yy = np.tile(ys, len(xs))
    return np.stack([xx, yy], axis=1).astype(np.int32)


def gather_windows(img: torch.Tensor, origins: torch.Tensor,
                   patch_size: int) -> torch.Tensor:
    """(N, P, P, C) windows at (N, 2) top-left ``origins`` of an (H, W, C)
    scene by one advanced-indexing gather; indices are clamped to the
    scene, so an out-of-range origin replicates the edge."""
    di = torch.arange(patch_size, device=img.device)
    r = (origins[:, 0, None, None] + di[None, :, None]).clamp(
        0, img.shape[0] - 1)
    c = (origins[:, 1, None, None] + di[None, None, :]).clamp(
        0, img.shape[1] - 1)
    return img[r, c]


def per_origin_map(apply_fn, scene1: torch.Tensor, scene2: torch.Tensor,
                   patch_size: int, n_classes: int, step: int,
                   chunk: int, rank: int = 0,
                   world_size: int = 1) -> torch.Tensor:
    """The (H, W, K) float32 map of the generic path (JAX
    ``_chunk_scatter_fn``): the origins of ``sliding_window_origins`` at
    ``step``, padded to a multiple of ``chunk`` with origin (0, 0) and
    ``valid`` 0, ``chunk`` windows a model call. Each window's float32
    logits, times ``valid``, add into its center pixel. The add
    accumulates repeated indices (``index_add_`` on the flattened map):
    when the scene fits in one chunk, the padding shares a scatter with
    the real origin (0, 0). Of ``world_size`` ranks, rank ``rank`` maps
    chunks rank, rank + world_size, ... only."""
    h, w = scene1.shape[:2]
    device = scene1.device
    p = patch_size
    origins = sliding_window_origins(h, w, p, step)
    n = len(origins)
    rem = -n % chunk
    origins = torch.as_tensor(np.concatenate(
        [origins, np.zeros((rem, 2), np.int32)]), dtype=torch.long,
        device=device)
    valid = torch.cat([torch.ones(n, device=device),
                       torch.zeros(rem, device=device)])
    centers = (origins[:, 0] + p // 2) * w + origins[:, 1] + p // 2
    probs = torch.zeros((h * w, n_classes), dtype=torch.float32,
                        device=device)
    for i in range(rank * chunk, n + rem, chunk * world_size):
        with span(CHUNK_SPAN):
            o = origins[i:i + chunk]
            out = apply_fn(gather_windows(scene1, o, p),
                           gather_windows(scene2, o, p))
            logits = out[0] if isinstance(out, tuple) else out
            probs.index_add_(0, centers[i:i + chunk],
                             logits.float() * valid[i:i + chunk, None])
    return probs.reshape(h, w, n_classes)


def band_patches(band: torch.Tensor, rows: int, patch_size: int):
    """(rows * Wc, P, P, C) windows of a (rows+P-1, W, C) band via P*P
    static slices; Wc = W - P + 1."""
    p = patch_size
    wc = band.shape[1] - p + 1
    parts = [band[i:i + rows, j:j + wc] for i in range(p) for j in range(p)]
    stacked = torch.stack(parts, dim=2)                  # (rows, Wc, P*P, C)
    return stacked.reshape(rows * wc, p, p, band.shape[-1])


@torch.inference_mode()
def full_scene_probabilities(model: torch.nn.Module, img1: np.ndarray,
                             img2: np.ndarray, hyperparams: Dict,
                             chunk: int = 8192,
                             cache: Optional[SceneCache] = None,
                             mesh: Optional[Mesh] = None) -> np.ndarray:
    """Class-score map (H, W, n_classes) of ``model`` (eval mode) over a
    scene, on the model's device. A model that returns a tuple (GLT_Net's
    ``(logits, con_loss)``) contributes its first entry.

    ``hyperparams["bf16"]`` serves under the bf16 policy (the model is
    cast in place, the scene is held in bf16, the map accumulates in
    float32). With ``hyperparams["applyPCA"]`` the HSI goes through the
    model's own ``pca_components`` (the reference hardcodes 3,
    QUIRKS.md), memoised in ``cache``. ``hyperparams["test_stride"]``
    (default 1) above 1 takes the per-origin path. The map comes back to
    the host as a numpy array. With ``mesh`` every rank calls with the
    same arguments, maps its share and gets the whole map."""
    with span(MAP_SPAN):
        probs = _scene_map(model, img1, img2, hyperparams, chunk, cache,
                           mesh)
        with span(DOWNLOAD_SPAN):
            return probs.cpu().numpy()


def _scene_map(model, img1, img2, hyperparams, chunk, cache, mesh):
    """The (H, W, n_classes) float32 map of
    :func:`full_scene_probabilities` on the model's device, summed over
    the mesh."""
    patch_size = int(hyperparams["patch_size"])
    n_classes = int(hyperparams["n_classes"])
    step = int(hyperparams.get("test_stride", 1))
    if step < 1:
        raise ValueError("test_stride {} < 1".format(step))

    device = next(model.parameters()).device
    bf16 = bool(hyperparams.get("bf16"))
    dtype = torch.bfloat16 if bf16 else torch.float32
    apply_fn = bf16_apply(model) if bf16 else model
    cache = cache if cache is not None else SceneCache()
    pca = (int(hyperparams.get("pca_components", 3))
           if hyperparams.get("applyPCA") else 0)
    scene1 = cache.get(img1, dtype, device, pca)
    scene2 = cache.get(img2, dtype, device)
    rank, n_dev = (mesh.rank, mesh.world_size) if mesh is not None else \
        (0, 1)
    if step > 1:
        probs = per_origin_map(apply_fn, scene1, scene2, patch_size,
                               n_classes, step, chunk, rank, n_dev)
        if mesh is not None:
            mesh.sum_(probs)
        return probs

    h, w = scene1.shape[:2]
    p = patch_size
    total = h - p + 1                       # origin rows
    wc = w - p + 1
    rows = max(1, min(total, chunk // max(wc, 1)))
    t_pad = -total % (rows * n_dev)         # whole groups of n_dev bands
    if t_pad:
        scene1 = torch.cat([scene1, scene1.new_zeros(
            (t_pad,) + tuple(scene1.shape[1:]))])
        scene2 = torch.cat([scene2, scene2.new_zeros(
            (t_pad,) + tuple(scene2.shape[1:]))])
    probs = torch.zeros((h + t_pad, w, n_classes), dtype=torch.float32,
                        device=device)
    row_ids = torch.arange(rows, device=device)
    for x0 in range(rank * rows, total + t_pad, rows * n_dev):
        with span(BAND_SPAN):
            band1 = scene1[x0:x0 + rows + p - 1]
            band2 = scene2[x0:x0 + rows + p - 1]
            out = apply_fn(band_patches(band1, rows, p),
                           band_patches(band2, rows, p))
            logits = out[0] if isinstance(out, tuple) else out
            block = logits.reshape(rows, wc, -1).float()
            # padding origin rows land inside the image for P >= 3: mask
            # them
            valid = (x0 + row_ids < total).float()
            probs[x0 + p // 2:x0 + p // 2 + rows, p // 2:p // 2 + wc] += \
                block * valid[:, None, None]
    if mesh is not None:
        mesh.sum_(probs)
    return probs[:h]
