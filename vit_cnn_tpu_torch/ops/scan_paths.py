"""Multi-directional scan orderings for vision-Mamba token sequences.

The reference hardcodes index tables for every ordering
(ref: model/Multimodality_Mamba/Mutimodality_Mamba7.py:455-466 eight
directions, :516-548 spirals, :609-640 the '81_2+8' set, :787-806 the
'49_2+8' set, :869-901 small spirals). Here each ordering is GENERATED
from the grid geometry; the generators were verified element-for-element
against all of the reference's 81- and 49-token tables.

Orderings (square grid of side n, row-major token ids):

* ``row_major`` / reversed — horizontal forward/reverse,
* ``col_boustrophedon`` — down column 0, up column 1, ... (the '_2+8'
  "vertical" path),
* ``col_major`` — plain transpose (the 'eight_directions' vertical path),
* ``zigzag`` — anti-diagonals alternating direction (JPEG-style),
* ``zigzag_mirror`` — the same from the top-right corner,
* ``diag`` / ``diag_mirror`` — plain top-down anti-diagonals
  (the 'eight_directions' diagonal paths),
* ``spiral_cw`` / ``spiral_ccw`` — clockwise / anticlockwise from
  top-left.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import List

import numpy as np


def row_major(n: int) -> np.ndarray:
    return np.arange(n * n)


def col_major(n: int) -> np.ndarray:
    return np.array([r * n + c for c in range(n) for r in range(n)])


def col_boustrophedon(n: int) -> np.ndarray:
    idx = []
    for c in range(n):
        rows = range(n) if c % 2 == 0 else range(n - 1, -1, -1)
        idx += [r * n + c for r in rows]
    return np.array(idx)


def diag(n: int) -> np.ndarray:
    idx = []
    for d in range(2 * n - 1):
        cells = [(r, d - r) for r in range(n) if 0 <= d - r < n]
        idx += [r * n + c for r, c in sorted(cells)]
    return np.array(idx)


def zigzag(n: int) -> np.ndarray:
    idx = []
    for d in range(2 * n - 1):
        cells = [(r, d - r) for r in range(n) if 0 <= d - r < n]
        cells = sorted(cells, key=lambda rc: rc[0], reverse=(d % 2 == 0))
        idx += [r * n + c for r, c in cells]
    return np.array(idx)


def _mirror_cols(order: np.ndarray, n: int) -> np.ndarray:
    r, c = order // n, order % n
    return r * n + (n - 1 - c)


def zigzag_mirror(n: int) -> np.ndarray:
    return _mirror_cols(zigzag(n), n)


def diag_mirror(n: int) -> np.ndarray:
    return _mirror_cols(diag(n), n)


def spiral_cw(n: int) -> np.ndarray:
    idx = []
    top, bot, left, right = 0, n - 1, 0, n - 1
    while top <= bot and left <= right:
        idx += [top * n + c for c in range(left, right + 1)]
        idx += [r * n + right for r in range(top + 1, bot + 1)]
        if top < bot:
            idx += [bot * n + c for c in range(right - 1, left - 1, -1)]
        if left < right:
            idx += [r * n + left for r in range(bot - 1, top, -1)]
        top += 1; bot -= 1; left += 1; right -= 1
    return np.array(idx)


def spiral_ccw(n: int) -> np.ndarray:
    idx = []
    top, bot, left, right = 0, n - 1, 0, n - 1
    while top <= bot and left <= right:
        idx += [r * n + left for r in range(top, bot + 1)]
        idx += [bot * n + c for c in range(left + 1, right + 1)]
        if left < right:
            idx += [r * n + right for r in range(bot - 1, top - 1, -1)]
        if top < bot:
            idx += [top * n + c for c in range(right - 1, left, -1)]
        top += 1; bot -= 1; left += 1; right -= 1
    return np.array(idx)


#: path types whose orderings are sequence-generic (no grid geometry) —
#: they work for any token count, including cls-extended sequences
#: (ref: :444-449, :929-981 all index with ``x.size(1)``).
SEQUENCE_PATHS = frozenset({
    "forward", "shuffle", "forward_reverse_mean", "forward_reverse_gate",
    "forward_reverse_shuffle_gate", "forward_reverse_shuffle_mean",
})


@lru_cache(maxsize=None)
def path_orderings(path_type: str, num_tokens: int) -> List[np.ndarray]:
    """List of STATIC token orderings for one of the reference's path types
    (dynamic shuffle streams are described by :func:`path_spec`, not here).

    '{L}_2+8' -> 10 orderings: horizontal fwd/rev, boustrophedon-vertical
    fwd/rev, zigzag / reversed, mirrored zigzag / reversed, spirals cw/ccw
    (ref: Mutimodality_Mamba7.py:608-701).
    'eight_directions_gate' -> 8: horizontal, col-major, plain diagonals,
    each fwd/rev (ref: :454-515).
    '{L}twoclock' -> the two spirals (ref: :516-607); '9twoclock' has its
    cw/acw tables SWAPPED in the reference (ref: :901-903) — replicated.
    'forward*'/'shuffle' -> sequence-order paths, any token count.
    """
    if path_type == "forward":
        return [np.arange(num_tokens)]
    if path_type == "shuffle":
        return []                       # single dynamic stream (path_spec)
    if path_type in ("forward_reverse_mean", "forward_reverse_gate",
                     "forward_reverse_shuffle_gate",
                     "forward_reverse_shuffle_mean"):
        f = np.arange(num_tokens)
        return [f, f[::-1].copy()]

    n = int(round(num_tokens ** 0.5))
    assert n * n == num_tokens, "token count must be a square grid"

    if path_type.endswith("_2+8"):
        vf = col_boustrophedon(n)
        zf = zigzag(n)
        zm = zigzag_mirror(n)
        return [row_major(n), row_major(n)[::-1].copy(), vf, vf[::-1].copy(),
                zf, zf[::-1].copy(), zm, zm[::-1].copy(),
                spiral_cw(n), spiral_ccw(n)]
    if path_type == "eight_directions_gate":
        vf = col_major(n)
        df = diag(n)
        dm = diag_mirror(n)
        return [row_major(n), row_major(n)[::-1].copy(), vf,
                vf[::-1].copy(), df, df[::-1].copy(), dm, dm[::-1].copy()]
    if path_type.endswith("twoclock"):
        if path_type == "9twoclock":
            # the reference's 3x3 tables label the anticlockwise spiral
            # "cw" and vice versa (ref: :901-903) — replicated verbatim
            return [spiral_ccw(n), spiral_cw(n)]
        return [spiral_cw(n), spiral_ccw(n)]
    raise ValueError("unknown path type {}".format(path_type))


@dataclasses.dataclass(frozen=True)
class PathSpec:
    """How a path type's streams are produced and combined.

    ``combine`` replicates the reference's per-path gate semantics exactly
    (each is a distinct literal branch upstream):

    * ``softmax10`` — learned (10,)-slot weights, softmaxed over ALL 10
      slots, first n_dir used. '_2+8' uses all 10 (ref: :700); twoclock
      uses 2 of 10 -> 0.1-weight sum at init (ref: :607); shuffle_gate
      uses 3 of 10 (ref: :970).
    * ``raw10`` — the same 10-slot weights WITHOUT softmax
      ('eight_directions_gate', ref: :514-515 — zeros-init, so the mixed
      stream starts at 0 and the block is pure-residual at init).
    * ``dynamic`` — per-sample gate: Linear(n_dir*hidden -> n_dir, no bias)
      + softmax over the token-means of the restored streams
      ('forward_reverse_gate', the only path using gate_layers,
      ref: :936-947).
    * ``mean`` — arithmetic mean ('forward_reverse_mean' /2 ref: :935,
      'forward_reverse_shuffle_mean' /3 ref: :985).
    * ``none`` — single stream, unit weight ('forward', 'shuffle').

    ``n_shuffle`` dynamic random-permutation streams (torch.randperm
    upstream, ref: :445, :950, :973) are appended after the static
    orderings. ``identity`` marks 'multi_clock_gate', the CLI's dead
    default: it matches NO branch upstream, so the layer body is skipped
    and the residual add doubles the tokens (ref: :303 + :987).
    """

    combine: str
    n_shuffle: int = 0
    identity: bool = False


@lru_cache(maxsize=None)
def path_spec(path_type: str) -> PathSpec:
    if path_type == "multi_clock_gate":
        return PathSpec(combine="none", identity=True)
    if path_type == "forward":
        return PathSpec(combine="none")
    if path_type == "shuffle":
        return PathSpec(combine="none", n_shuffle=1)
    if path_type == "forward_reverse_mean":
        return PathSpec(combine="mean")
    if path_type == "forward_reverse_gate":
        return PathSpec(combine="dynamic")
    if path_type == "forward_reverse_shuffle_gate":
        return PathSpec(combine="softmax10", n_shuffle=1)
    if path_type == "forward_reverse_shuffle_mean":
        return PathSpec(combine="mean", n_shuffle=1)
    if path_type == "eight_directions_gate":
        return PathSpec(combine="raw10")
    if path_type.endswith("twoclock") or path_type.endswith("_2+8"):
        return PathSpec(combine="softmax10")
    raise ValueError("unknown path type {}".format(path_type))


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    return np.argsort(perm)


@lru_cache(maxsize=None)
def base_paths(path_type: str, num_tokens: int):
    """Factor the ordering list into gather-once bases.

    Many orderings come in (forward, exact-reverse) pairs; a reverse path
    needs no second gather — scanning the base's gathered sequence
    back-to-front and inverse-scattering with the base's inverse permutation
    is identical (position algebra: token s sits at position j in the
    reversed order iff it sits at position L-1-j in the base; the reverse
    scan emits its value at exactly L-1-j).

    Returns (orders, bases, fwd_dir, rev_dir) where ``bases`` indexes into
    ``orders``, ``fwd_dir[i]`` is the direction index served by scanning
    base i forward, and ``rev_dir[i]`` is the direction index served by the
    reverse scan (or -1 when that base has no reversed twin).
    """
    orders = path_orderings(path_type, num_tokens)
    used = [False] * len(orders)
    bases, fwd_dir, rev_dir = [], [], []
    for i, o in enumerate(orders):
        if used[i]:
            continue
        used[i] = True
        rev = -1
        for j in range(i + 1, len(orders)):
            if not used[j] and np.array_equal(o[::-1], orders[j]):
                rev = j
                used[j] = True
                break
        bases.append(i)
        fwd_dir.append(i)
        rev_dir.append(rev)
    return orders, bases, fwd_dir, rev_dir
