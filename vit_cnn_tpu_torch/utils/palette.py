"""Label <-> RGB color codec for prediction maps.

Parity with ref: utils.py:124-166 and the palette generation at
ref: main.py:323-328 (seaborn pastel+bright), with a deterministic fallback
when seaborn is unavailable.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def build_palette(n_labels: int) -> Dict[int, Tuple[int, int, int]]:
    """label -> RGB. Label 0 is black (ref: main.py:323-328)."""
    palette = {0: (0, 0, 0)}
    try:
        import seaborn as sns

        colors = (sns.color_palette("pastel", 10)
                  + sns.color_palette("bright", max(n_labels - 1 - 10, 0)))
    except Exception:  # deterministic HSV wheel fallback
        import colorsys

        colors = [colorsys.hsv_to_rgb(i / max(n_labels - 1, 1), 0.75, 0.95)
                  for i in range(n_labels - 1)]
    for k, color in enumerate(colors):
        palette[k + 1] = tuple(np.asarray(255 * np.array(color), dtype="uint8"))
    return palette


def convert_to_color(arr_2d: np.ndarray, palette: Dict) -> np.ndarray:
    """2D labels -> RGB uint8 image (ref: utils.py:124-143)."""
    arr_3d = np.zeros((arr_2d.shape[0], arr_2d.shape[1], 3), dtype=np.uint8)
    if palette is None:
        raise Exception("Unknown color palette")
    for c, col in palette.items():
        arr_3d[arr_2d == c] = col
    return arr_3d


def convert_from_color(arr_3d: np.ndarray, palette: Dict) -> np.ndarray:
    """RGB image -> 2D labels; `palette` maps RGB tuple -> label
    (ref: utils.py:146-166)."""
    if palette is None:
        raise Exception("Unknown color palette")
    arr_2d = np.zeros((arr_3d.shape[0], arr_3d.shape[1]), dtype=np.uint8)
    for c, i in palette.items():
        m = np.all(arr_3d == np.array(c).reshape(1, 1, 3), axis=2)
        arr_2d[m] = i
    return arr_2d
