"""Classification metrics: confusion matrix, OA, per-class F1 and
"precision", AA and Cohen's Kappa (the port's copy of
:mod:`vit_cnn_tpu.metrics.classification`, ref: utils.py:585-663).

The reference's quirks are kept: "Precisions" is cm[i, i] / row sum (the
per-class recall, under the reference's name), F1 and precision of an
empty class are NaN, and AA averages the recalls that are not NaN.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def confusion(prediction: np.ndarray, target: np.ndarray,
              n_classes: int) -> np.ndarray:
    """Row = true class, column = predicted class."""
    mask = (target >= 0) & (target < n_classes)
    idx = (n_classes * target[mask].astype(np.int64)
           + prediction[mask].astype(np.int64))
    cm = np.bincount(idx, minlength=n_classes * n_classes)
    return cm.reshape(n_classes, n_classes)


def metrics(prediction: np.ndarray, target: np.ndarray,
            ignored_labels: Sequence[int] = (), n_classes: int = None
            ) -> Dict:
    """OA / AA / Kappa / F1 / precision and the confusion matrix, over the
    pixels whose target label is not ignored."""
    ignored_mask = np.zeros(target.shape[:2], dtype=bool)
    for label in ignored_labels:
        ignored_mask[target == label] = True
    keep = ~ignored_mask
    target = target[keep]
    prediction = prediction[keep]

    results: Dict = {}
    n_classes = int(np.max(target)) + 1 if n_classes is None else n_classes
    cm = confusion(prediction, target, n_classes)
    results["Confusion matrix"] = cm

    total = np.sum(cm)
    results["Accuracy"] = float(np.trace(cm)) * 100.0 / float(total)

    with np.errstate(divide="ignore", invalid="ignore"):
        diag = np.diag(cm).astype(np.float64)
        row = cm.sum(axis=1).astype(np.float64)
        col = cm.sum(axis=0).astype(np.float64)
        f1 = 2.0 * diag / (row + col)          # NaN when row + col == 0
        prec = diag / row                      # NaN when row == 0 (recall)
    results["F1 scores"] = f1
    results["Precisions"] = prec

    recalls = prec[~np.isnan(prec)]
    results["AA"] = float(np.mean(recalls)) if recalls.size else float("nan")

    pa = np.trace(cm) / float(total)
    pe = np.sum(cm.sum(axis=0) * cm.sum(axis=1)) / float(total) ** 2
    results["Kappa"] = float((pa - pe) / (1 - pe))
    return results
