"""Ground-truth train / test splits without scikit-learn.

:func:`vit_cnn_tpu.data.sampling.sample_gt` imports scikit-learn, which
the GPU host does not have. This is its port, mode for mode:

* ``random`` — the stratified split of ``sklearn.model_selection.
  train_test_split(X, train_size=..., stratify=y)`` with no random_state,
  rewritten in numpy step for step (``_validate_shuffle_split``,
  ``StratifiedShuffleSplit._iter_indices``, ``_approximate_mode``) and
  drawing from numpy's global RandomState as scikit-learn does, so the
  same ``np.random.seed`` gives the same split;
* ``fixed`` — per class, the unstratified ``train_test_split(Xc,
  train_size=...)`` (``ShuffleSplit``: one global ``permutation``, the
  test part first);
* ``disjoint`` — per class, the rows above the first row where more than
  0.9 x train_size of the class lies above go to training;
* ``random_fixednumber`` — N per class (:func:`sampling_fixed_num`, the
  reference's RNG call order).

:func:`compute_imf_weights` gives the inverse-median-frequency class
weights of ``--class_balancing``.
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


def _split_sizes(n: int, train_size: float) -> Tuple[int, int]:
    """(n_train, n_test) of scikit-learn's ``_validate_shuffle_split`` for a
    ``train_size`` (a fraction or a count) and no test size."""
    if isinstance(train_size, float):
        if not 0 < train_size < 1:
            raise ValueError("train_size={} should be a float in the (0, 1) "
                             "range or a count".format(train_size))
        n_train = math.floor(train_size * n)
    else:
        n_train = int(train_size)
        if not 0 < n_train < n:
            raise ValueError("train_size={} should be positive and smaller "
                             "than the number of samples {}".format(
                                 train_size, n))
    if n_train == 0:
        raise ValueError("With n_samples={} and train_size={}, the train "
                         "set would be empty".format(n, train_size))
    return n_train, n - n_train


def shuffle_split(n: int, train_size: float
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(train, test) positions of scikit-learn's unstratified
    ``train_test_split`` of ``n`` samples (``ShuffleSplit``)."""
    n_train, n_test = _split_sizes(n, train_size)
    permutation = np.random.mtrand._rand.permutation(n)
    return permutation[n_test:n_test + n_train], permutation[:n_test]


def stratified_split(y: np.ndarray, train_size: float
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(train, test) positions into ``y``, as scikit-learn's stratified
    ``train_test_split`` gives them (train_size a fraction or a count)."""
    rng = np.random.mtrand._rand          # scikit-learn's random_state=None
    n = len(y)
    n_train, n_test = _split_sizes(n, train_size)
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
    elif mode == "fixed":
        for c in np.unique(gt):
            if c == 0:
                continue
            rows, cols = np.nonzero(gt == c)
            train, test = shuffle_split(len(rows), train_size)
            for idx, out in ((train, train_gt), (test, test_gt)):
                out[rows[idx], cols[idx]] = c
    elif mode == "disjoint":
        train_gt = np.copy(gt)
        test_gt = np.copy(gt)
        for c in np.unique(gt):
            mask = gt == c
            for x in range(gt.shape[0]):
                first_half = np.count_nonzero(mask[:x, :])
                second_half = np.count_nonzero(mask[x:, :])
                total = first_half + second_half
                if total == 0:
                    continue
                if first_half / total > 0.9 * train_size:
                    break
            mask[:x, :] = 0
            train_gt[mask] = 0
        test_gt[train_gt > 0] = 0
    elif mode == "random_fixednumber":
        flat = gt.reshape(-1).astype(np.int64)
        train_idx, test_idx = sampling_fixed_num(int(train_size), flat, seed)
        train_gt.reshape(-1)[train_idx] = flat[train_idx]
        test_gt.reshape(-1)[test_idx] = flat[test_idx]
    else:
        raise ValueError("{} sampling is not implemented yet.".format(mode))
    return train_gt, test_gt
