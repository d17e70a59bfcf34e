"""Ground-truth train / test splits without scikit-learn.

:func:`vit_cnn_tpu.data.sampling.sample_gt` imports scikit-learn, which
the GPU host does not have. This is its port for the modes the training
run uses:

* ``random`` — the stratified split of ``sklearn.model_selection.
  train_test_split(X, train_size=..., stratify=y)`` with no random_state,
  rewritten in numpy step for step (``_validate_shuffle_split``,
  ``StratifiedShuffleSplit._iter_indices``, ``_approximate_mode``) and
  drawing from numpy's global RandomState as scikit-learn does, so the
  same ``np.random.seed`` gives the same split;
* ``random_fixednumber`` — N per class (:func:`sampling_fixed_num`, the
  reference's RNG call order).

:func:`compute_imf_weights` gives the inverse-median-frequency class
weights of ``--class_balancing``.

'fixed' and 'disjoint' raise (ROADMAP Queue 1, the CLI run loop).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np


def sampling_fixed_num(sample_num: int, ground_truth: np.ndarray,
                       seed: int) -> Tuple[List[int], List[int]]:
    """``sample_num`` flat indices per class 1..max(gt) for training, the
    rest for testing (ref: utils.py:754-773), reproducing the reference's
    RNG call order so the same seed gives the same split."""
    np.random.seed(seed)
    m = int(ground_truth.max())
    train_, test_ = {}, {}
    flat = ground_truth.ravel()
    for i in range(m):
        indices = np.nonzero(flat == i + 1)[0].tolist()
        np.random.shuffle(indices)
        train_[i] = indices[:sample_num]
        test_[i] = indices[sample_num:]
    train_fix: List[int] = []
    test_fix: List[int] = []
    for i in range(m):
        train_fix += train_[i]
        test_fix += test_[i]
    np.random.shuffle(train_fix)
    np.random.shuffle(test_fix)
    return train_fix, test_fix


def compute_imf_weights(ground_truth: np.ndarray, n_classes: int = None,
                        ignored_classes: Sequence[int] = ()) -> np.ndarray:
    """Inverse-median-frequency class weights (ref: utils.py:849-881)."""
    n_classes = int(np.max(ground_truth)) if n_classes is None else n_classes
    weights = np.zeros(n_classes)
    frequencies = np.zeros(n_classes)
    for c in range(n_classes):
        if c in ignored_classes:
            continue
        frequencies[c] = np.count_nonzero(ground_truth == c)
    frequencies /= np.sum(frequencies)
    idx = np.nonzero(frequencies)
    median = np.median(frequencies[idx])
    weights[idx] = median / frequencies[idx]
    weights[frequencies == 0] = 0.0
    return weights


def _approximate_mode(class_counts: np.ndarray, n_draws: int,
                      rng: np.random.RandomState) -> np.ndarray:
    """scikit-learn's approximate mode of the multivariate hypergeometric,
    ties broken with ``rng.choice``."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            floored[rng.choice(inds, size=add_now, replace=False)] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_split(y: np.ndarray, train_size: float
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(train, test) positions into ``y``, as scikit-learn's stratified
    ``train_test_split`` gives them (train_size a fraction or a count)."""
    rng = np.random.mtrand._rand          # scikit-learn's random_state=None
    n = len(y)
    if isinstance(train_size, float):
        n_train = math.floor(train_size * n)
    else:
        n_train = int(train_size)
    n_test = n - n_train
    classes, y_indices, class_counts = np.unique(
        y, return_inverse=True, return_counts=True)
    if class_counts.min() < 2 or n_train < len(classes) or \
            n_test < len(classes):
        raise ValueError("a stratified split needs >= 2 samples per class "
                         "and >= one per class on each side")
    class_indices = np.split(np.argsort(y_indices, kind="stable"),
                             np.cumsum(class_counts)[:-1])
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(len(classes)):
        perm = class_indices[i].take(rng.permutation(class_counts[i]),
                                     mode="clip")
        train.extend(perm[:n_i[i]])
        test.extend(perm[n_i[i]:n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def sample_gt(gt: np.ndarray, train_size: float, mode: str = "random",
              seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Split a 2D GT map into train / test GT maps (ref: utils.py:775-846)."""
    train_gt = np.zeros_like(gt)
    test_gt = np.zeros_like(gt)
    if train_size > 1:
        train_size = int(train_size)
    if mode == "random":
        rows, cols = np.nonzero(gt)
        train, test = stratified_split(gt[rows, cols].ravel(), train_size)
        for idx, out in ((train, train_gt), (test, test_gt)):
            out[rows[idx], cols[idx]] = gt[rows[idx], cols[idx]]
    elif mode == "random_fixednumber":
        flat = gt.reshape(-1).astype(np.int64)
        train_idx, test_idx = sampling_fixed_num(int(train_size), flat, seed)
        train_gt.reshape(-1)[train_idx] = flat[train_idx]
        test_gt.reshape(-1)[test_idx] = flat[test_idx]
    else:
        raise NotImplementedError(
            "sampling mode {!r} is not ported yet: ROADMAP Queue 1, the CLI "
            "run loop".format(mode))
    return train_gt, test_gt
