"""Patch pipeline: the scenes on the device, batches gathered there.

Port of :mod:`vit_cnn_tpu.pipeline.patches`:

* :func:`interior_indices`, :func:`build_class_index_table` — host-side
  index selection, numpy, identical to the JAX module's;
* :func:`gather_patches` — (B, P, P, C) patches around (B, 2) centers by
  one advanced-indexing gather, with per-sample offset grids and the same
  clamp to the scene;
* :func:`_geom_offset_grids`, :func:`sample_geom_code` — the seven
  flip/rotate transforms as offset grids, and the per-sample draw with
  the reference's probabilities from an explicit ``torch.Generator`` on
  the device (its bits are not jax.random's; tests feed explicit codes);
* :func:`radiation_noise`, :func:`mixture_noise` — the reference's two
  spectral noises (ref: datasets.py:528-545) on a batch, their draws
  (:func:`draw_noise`) made batched on the generator's device and passed
  in explicitly, so a test can hand in the JAX package's draws;
* :class:`PatchPipeline` — ``make_batch`` (flip/rotate folded into the
  gather, then radiation noise with p 0.1, then mixture noise with p 0.2,
  on the HSI only), ``to_compute_dtype``, ``epoch_order`` (the same
  ``np.random.RandomState`` permutation as JAX, so the shuffle order is
  identical) and ``device_arrays``.

Under the bf16 policy the scenes are bf16, and the noises compute as the
JAX package's jitted step does: the float32 weights promote a noised
patch to float32, and the forward casts the batch to bf16. The normal
noise stays float32: JAX draws it in the patch's dtype, but XLA computes
the draw fused into the float32 sum at float32 precision (on the CPU the
jitted program's bf16 normal is not rounded to bf16).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel import mesh

from ..nn.noise import affine

#: per-sample probabilities of the two noises (ref: datasets.py:699-707)
RADIATION_P, MIXTURE_P = 0.1, 0.2
BETA = 1.0 / 25


def interior_indices(gt: np.ndarray, patch_size: int,
                     ignored_labels: Sequence[int],
                     supervision: str = "full",
                     include_ignored: bool = False) -> np.ndarray:
    """(N, 2) array of labeled pixel centers strictly inside the border
    (ref: datasets.py:489-504): pixels with non-ignored labels (all pixels
    for 'semi' supervision or include_ignored=True), restricted to
    ``x > p and x < H - p`` with p = patch_size // 2."""
    mask = np.ones_like(gt)
    if not (supervision == "semi" or include_ignored):
        for label in set(ignored_labels):
            mask[gt == label] = 0
    x_pos, y_pos = np.nonzero(mask)
    p = patch_size // 2
    h, w = gt.shape
    keep = (x_pos > p) & (x_pos < h - p) & (y_pos > p) & (y_pos < w - p)
    return np.stack([x_pos[keep], y_pos[keep]], axis=1).astype(np.int32)


def build_class_index_table(gt: np.ndarray, indices: np.ndarray,
                            n_classes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-class table of training centers, padded to the max class count
    (table[n_classes, M, 2], counts); empty classes point at (0, 0)."""
    labels = gt[indices[:, 0], indices[:, 1]]
    counts = np.array([int(np.sum(labels == c)) for c in range(n_classes)],
                      dtype=np.int32)
    table = np.zeros((n_classes, max(int(counts.max()), 1), 2), np.int32)
    for c in range(n_classes):
        rows = indices[labels == c]
        table[c, :len(rows)] = rows
    return table, counts


def gather_patches(img: torch.Tensor, centers: torch.Tensor, patch_size: int,
                   offsets: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                   ) -> torch.Tensor:
    """(B, P, P, C) patches around (B, 2) int centers of an (H, W, C)
    scene. ``offsets``: per-sample (B, P, P) row / col offset grids (the
    flip/rotate folded into the gather). Index grids are clamped to the
    scene, so a non-interior center replicates the edge."""
    p = patch_size // 2
    centers = centers.long()
    if offsets is None:
        di = torch.arange(patch_size, device=img.device) - p
        r = centers[:, 0, None, None] + di[None, :, None]
        c = centers[:, 1, None, None] + di[None, None, :]
    else:
        r = centers[:, 0, None, None] + offsets[0]
        c = centers[:, 1, None, None] + offsets[1]
    r = r.clamp(0, img.shape[0] - 1)
    c = c.clamp(0, img.shape[1] - 1)
    return img[r, c]


@lru_cache(maxsize=None)
def _geom_offset_grids(patch_size: int):
    """(7, P, P) row / col offset grids: gathering with grid k applies
    transform k (0 identity, 1 fliplr, 2 flipud, 3 both, 4/5/6 rot90
    k=1/2/3) to the patch, since T(patch)[i, j] = img[center + T(grid0)[i, j]].
    numpy, converted per device by the caller."""
    di = np.arange(patch_size) - patch_size // 2
    r0, c0 = np.meshgrid(di, di, indexing="ij")
    tfs = [lambda a: a,
           np.fliplr,
           np.flipud,
           lambda a: np.flipud(np.fliplr(a)),
           lambda a: np.rot90(a, k=1),
           lambda a: np.rot90(a, k=2),
           lambda a: np.rot90(a, k=3)]
    rs = np.stack([t(r0) for t in tfs]).astype(np.int32)
    cs = np.stack([t(c0) for t in tfs]).astype(np.int32)
    return rs, cs


def sample_geom_code(generator: torch.Generator, batch: int) -> torch.Tensor:
    """(batch,) flip/rotate codes with the reference's probabilities
    (ref: datasets.py:510-526 + 559-564): with p=1/2 the flip branch
    (independent lr / ud coin flips), else the rotate branch (p=1/2 rotate
    by k in {1, 2, 3}, else identity). Drawn on the generator's device."""
    u = torch.rand((5, batch), generator=generator,
                   device=generator.device)
    take_flip, h, v, do_rot = u[0] > 0.5, u[1] > 0.5, u[2] > 0.5, u[3] > 0.5
    k = (u[4] * 3).long().clamp(max=2) + 1
    flip_code = h.long() + 2 * v.long()
    rot_code = torch.where(do_rot, 3 + k, torch.zeros_like(k))
    return torch.where(take_flip, flip_code, rot_code)


def radiation_noise(data: torch.Tensor, alpha: torch.Tensor,
                    noise: torch.Tensor, beta: float = BETA) -> torch.Tensor:
    """alpha * data + beta * N(0, 1) (ref: datasets.py:528-532) for (B,)
    float32 ``alpha`` in [0.9, 1.1) and float32 standard normal ``noise``
    of data's shape."""
    return alpha.view(-1, 1, 1, 1) * data + beta * noise


def mixture_noise(data: torch.Tensor, label_patch: torch.Tensor,
                  scene: torch.Tensor, class_table: torch.Tensor,
                  class_counts: torch.Tensor, ignored_mask: torch.Tensor,
                  alpha: torch.Tensor, pick: torch.Tensor,
                  noise: torch.Tensor, beta: float = BETA) -> torch.Tensor:
    """Blend each pixel with a random same-class training spectrum (ref:
    datasets.py:534-545): pixel (i, j) of sample b, with label l =
    ``label_patch[b, i, j]``, takes the spectrum of ``scene`` at row
    floor(pick * max(count_l, 1)) of class l's table as its partner (zero
    for an ignored or empty class), and becomes (a1 d + a2 partner) /
    (a1 + a2) + beta * N(0, 1). ``alpha``: (B, 2) float32 weights in
    [0.01, 1); ``pick``: (B, P, P) uniforms; ``noise``: float32 standard
    normal of data's shape."""
    cnt = class_counts[label_patch]
    rows = torch.floor(pick * cnt.clamp_min(1)).long()
    rc = class_table[label_patch, rows]                   # (B, P, P, 2)
    partner = scene[rc[..., 0], rc[..., 1]]
    ign = ignored_mask[label_patch] | (cnt == 0)
    partner = partner.masked_fill(ign[..., None], 0)
    a1 = alpha[:, 0].view(-1, 1, 1, 1)
    a2 = alpha[:, 1].view(-1, 1, 1, 1)
    return (a1 * data + a2 * partner) / (a1 + a2) + beta * noise


def batch_codes(generator: torch.Generator, batch: int) -> torch.Tensor:
    """:func:`sample_geom_code` for a batch of ``batch`` local centers:
    drawn at the global batch under an engaged mesh, this rank's rows
    kept."""
    return mesh.shard_rows(sample_geom_code(generator,
                                            batch * mesh.world_size()))


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    flip: bool = False
    radiation: bool = False
    mixture: bool = False


class PatchPipeline:
    """Owns the device scenes and produces training batches."""

    def __init__(self, img1: np.ndarray, img2: np.ndarray, gt: np.ndarray,
                 patch_size: int, ignored_labels: Sequence[int],
                 n_classes: int, augment: AugmentConfig = AugmentConfig(),
                 supervision: str = "full", device="cpu"):
        self.patch_size = int(patch_size)
        self.augment_cfg = augment
        self.n_classes = n_classes

        as_f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                           device=device)
        self.scene1 = as_f32(img1)
        self.scene2 = as_f32(img2)
        self.device = self.scene1.device          # with its index
        self.gt = torch.as_tensor(gt.astype(np.int64), device=self.device)

        self.indices = interior_indices(gt, patch_size, ignored_labels,
                                        supervision)
        ign = np.zeros(n_classes, dtype=bool)
        for label in ignored_labels:
            if 0 <= label < n_classes:
                ign[label] = True
        self.ignored_mask = torch.as_tensor(ign, device=self.device)
        self.class_table = self.class_counts = None
        if augment.mixture:
            table, counts = build_class_index_table(gt, self.indices,
                                                    n_classes)
            self.class_table = torch.as_tensor(table, dtype=torch.long,
                                               device=self.device)
            self.class_counts = torch.as_tensor(counts, dtype=torch.long,
                                                device=self.device)
        gr, gc = _geom_offset_grids(self.patch_size)
        self._grids = (torch.as_tensor(gr, dtype=torch.long,
                                       device=self.device),
                       torch.as_tensor(gc, dtype=torch.long,
                                       device=self.device))

    def to_compute_dtype(self, dtype) -> None:
        """Re-store the gather sources in the training compute dtype: the
        gather is bit-identical (a cast commutes with it) and moves half
        the bytes in bf16. Labels stay int."""
        self.scene1 = self.scene1.to(dtype)
        self.scene2 = self.scene2.to(dtype)

    def __len__(self) -> int:
        return len(self.indices)

    def epoch_order(self, rng: np.random.RandomState) -> np.ndarray:
        """Shuffled copy of the center list (DataLoader(shuffle=True))."""
        return self.indices[rng.permutation(len(self.indices))]

    def device_arrays(self):
        return {"scene1": self.scene1, "scene2": self.scene2, "gt": self.gt}

    def draw_noise(self, generator: torch.Generator,
                   shape: Sequence[int]) -> Dict[str, torch.Tensor]:
        """The draws of the configured noises for a batch of HSI patches
        of ``shape`` (B, P, P, C), made on the generator's device: per
        sample a gate uniform and the weights, per pixel the mixture's
        pick, and the normal noise."""
        cfg, g = self.augment_cfg, generator
        b, dev = shape[0], generator.device
        draws = {}
        if cfg.radiation:
            u = torch.rand((2, b), generator=g, device=dev)
            draws.update(radiation_gate=u[0],
                         radiation_alpha=affine(u[1], 0.9, 1.1),
                         radiation_noise=torch.randn(
                             tuple(shape), generator=g, device=dev))
        if cfg.mixture:
            u = torch.rand((b, 3), generator=g, device=dev)
            draws.update(mixture_gate=u[:, 0],
                         mixture_alpha=affine(u[:, 1:], 0.01, 1.0),
                         mixture_pick=torch.rand(tuple(shape[:3]),
                                                 generator=g, device=dev),
                         mixture_noise=torch.randn(
                             tuple(shape), generator=g, device=dev))
        return draws

    def batch_noise(self, generator: torch.Generator,
                    shape: Sequence[int]) -> Dict[str, torch.Tensor]:
        """:meth:`draw_noise` for a local batch of ``shape``: drawn at the
        global batch under an engaged mesh, each draw cut to this rank's
        rows (after ``draw_noise`` every draw leads with the batch)."""
        full = (shape[0] * mesh.world_size(),) + tuple(shape[1:])
        return {k: mesh.shard_rows(v)
                for k, v in self.draw_noise(generator, full).items()}

    def add_noise(self, generator: Optional[torch.Generator],
                  p1: torch.Tensor, label_patch: torch.Tensor,
                  draws: Optional[Dict[str, torch.Tensor]] = None
                  ) -> torch.Tensor:
        """Radiation noise (p 0.1 a sample), then mixture noise (p 0.2) on
        the HSI patches ``p1``, the configured ones, with the (post-flip)
        ``label_patch``; ``draws`` (:meth:`draw_noise`'s keys) instead of
        drawing from ``generator``."""
        cfg = self.augment_cfg
        if not (cfg.radiation or cfg.mixture):
            return p1
        if draws is None:
            draws = self.batch_noise(generator, p1.shape)
        if cfg.radiation:
            gate = (draws["radiation_gate"] < RADIATION_P).view(-1, 1, 1, 1)
            p1 = torch.where(gate, radiation_noise(
                p1, draws["radiation_alpha"], draws["radiation_noise"]), p1)
        if cfg.mixture:
            gate = (draws["mixture_gate"] < MIXTURE_P).view(-1, 1, 1, 1)
            p1 = torch.where(gate, mixture_noise(
                p1, label_patch, self.scene1, self.class_table,
                self.class_counts, self.ignored_mask,
                draws["mixture_alpha"], draws["mixture_pick"],
                draws["mixture_noise"]), p1)
        return p1

    def make_batch(self, generator: Optional[torch.Generator],
                   centers: torch.Tensor, train: bool = True,
                   codes: Optional[torch.Tensor] = None,
                   draws: Optional[Dict[str, torch.Tensor]] = None):
        """Gather (and, for training, flip/rotate when flip is on, then the
        configured noises) one batch: (hsi_patches, lidar_patches,
        center_labels). ``codes`` gives the per-sample transforms and
        ``draws`` the noises' draws explicitly instead of drawing them
        from ``generator``. The label is the patch's center pixel after
        the flip, as every ported model's ``center_pixel=True`` asks."""
        p = self.patch_size
        offsets = None
        if train and self.augment_cfg.flip and p > 1:
            if codes is None:
                codes = batch_codes(generator, centers.shape[0])
            offsets = (self._grids[0][codes], self._grids[1][codes])
        p1 = gather_patches(self.scene1, centers, p, offsets)
        p2 = gather_patches(self.scene2, centers, p, offsets)
        lp = gather_patches(self.gt[..., None], centers, p, offsets)[..., 0]
        if train:
            p1 = self.add_noise(generator, p1, lp, draws)
        return p1, p2, lp[:, p // 2, p // 2]
