"""Variants of the selective-scan forward (kernel K1) for the tuning sweep.

Ports of the JAX package's tuning probes, forward only as they are:

* :func:`selective_scan_tiled` — V1 (``csrc/selective_scan_fwd.cu``
  ``vct_selective_scan_tiled``, the counterpart of ``perf/scan_sweep.py``
  ``_kernel_lanemajor``): K1's own kernel template at one instance of
  its (channels per block, staged time steps) grid, :data:`TILE_ROWS` x
  :data:`TILE_CHUNKS`: 4 warps x R in {1, 2, 4} channels a thread, by 2,
  4 or 8 steps a staging buffer. The instance at K1's plan
  (:func:`k1_instance`) is K1 itself, bit for bit. Its plain version is
  :func:`.selective_scan.selective_scan_reference`; lane-major layout.
* :func:`selective_scan_batch_major` — V2 (``csrc/scan_variants.cu``, the
  counterpart of ``perf/scan_bm_sweep.py`` ``_scan_kernel_bm``): the scan
  read and written in the mixer's batch-major layout, u, dt (b, L, d) and
  B, C (b, L, n); threads run along d of one sequence (2 channels a
  thread in bf16, 1 in float32), so each step's B and C, staged a chunk
  ahead by ``cp.async``, are read as broadcasts. Its plain version,
  :func:`selective_scan_batch_major_reference`, permutes to lane-major,
  runs the plain scan and permutes back.

Each wrapper takes its plain version for CPU tensors and launches its
kernel for CUDA tensors, or raises; it raises for an input that requires
a gradient (the kernels have no backward).
"""

from __future__ import annotations

import torch

from . import _build
from .selective_scan import (SCAN_CHUNK, _check, _dims, scan_tile,
                             selective_scan_reference)

TILE_ROWS = (4, 8, 16)       # channels per block: 4 warps x R in {1, 2, 4}
TILE_CHUNKS = (2, 4, 8)      # time steps of B and C a staging buffer
MAX_STATE = 16               # n compiled into the kernels
BATCH_MAJOR_MAX_D = 1024     # V2: one thread per channel of a sequence


def k1_instance(ns: int, L: int, d: int, n: int, b: int,
                dtype=torch.bfloat16):
    """The (rows, chunk) instance of V1's grid that K1 launches for this
    shape: rows = 4 warps x K1's R (:func:`.selective_scan.scan_tile`),
    chunk = K1's :data:`.selective_scan.SCAN_CHUNK` steps."""
    R, warps = scan_tile(ns, L, d, n, b, dtype)
    return warps * R, SCAN_CHUNK


def selective_scan_tiled(u, dt, A, B, C, D, reverse: bool = False,
                         rows: int = 8, chunk: int = 4):
    """The scan on u's device: the plain version on the CPU, the (rows,
    chunk) instance of K1's grid (V1) on CUDA. Layouts as K1's: u, dt
    (L, d, b) or (ns, L, d, b); B, C (L, n, b) or (ns, L, n, b)."""
    _build.forward_only("the scan variants", u, dt, A, B, C, D)
    if rows not in TILE_ROWS or chunk not in TILE_CHUNKS:
        raise ValueError("V1 instances are rows in {} x chunk in {}; got "
                         "({}, {})".format(TILE_ROWS, TILE_CHUNKS, rows,
                                           chunk))
    if _build.use_plain(u):
        return selective_scan_reference(u, dt, A, B, C, D, reverse)
    _check(u, dt, A, B, C, D)
    A32, D32 = A.float().contiguous(), D.float().contiguous()
    _build.check_inputs(u, dt, A32, B, C, D32)
    ns, L, d, n, b = _dims(u, A)
    y = torch.empty_like(u)
    with torch.cuda.device(u.device):
        code = _build.lib().vct_selective_scan_tiled(
            _build.dtype_code(u), u.data_ptr(), dt.data_ptr(), A32.data_ptr(),
            B.data_ptr(), C.data_ptr(), D32.data_ptr(), y.data_ptr(),
            ns, L, d, n, b, int(reverse), rows, chunk, _build.stream_of(u))
    _build.check("selective_scan_tiled", code)
    _build.launches["selective_scan_tiled"] += 1
    return y


def selective_scan_batch_major_reference(u, dt, A, B, C, D):
    """The plain forward scan of batch-major u, dt (b, L, d), B, C
    (b, L, n): lane-major views through the plain scan, y as (b, L, d)."""
    lane = lambda x: x.permute(1, 2, 0)
    y = selective_scan_reference(lane(u), lane(dt), A, lane(B), lane(C), D)
    return y.permute(2, 0, 1).contiguous()


def selective_scan_batch_major(u, dt, A, B, C, D):
    """The forward scan of batch-major inputs on u's device: the plain
    version on the CPU, V2 on CUDA. u, dt (b, L, d); B, C (b, L, n); A
    (d, n); D (d,); y (b, L, d) in u's dtype."""
    _build.forward_only("the scan variants", u, dt, A, B, C, D)
    if u.dim() != 3 or dt.shape != u.shape:
        raise ValueError("u/dt must be (b, L, d) alike")
    b, L, d = u.shape
    n = A.shape[1]
    if (A.shape != (d, n) or B.shape != (b, L, n) or C.shape != B.shape
            or D.shape != (d,)):
        raise ValueError("shape mismatch: u {} B {} C {} A {} D {}".format(
            tuple(u.shape), tuple(B.shape), tuple(C.shape), tuple(A.shape),
            tuple(D.shape)))
    if not (dt.dtype == B.dtype == C.dtype == u.dtype):
        raise TypeError("u, dt, B and C must share one dtype")
    if not (1 <= n <= MAX_STATE and d <= BATCH_MAJOR_MAX_D):
        raise ValueError("V2 takes n <= {} and d <= {}; got n={}, d={}"
                         .format(MAX_STATE, BATCH_MAJOR_MAX_D, n, d))
    if _build.use_plain(u):
        return selective_scan_batch_major_reference(u, dt, A, B, C, D)
    A32, D32 = A.float().contiguous(), D.float().contiguous()
    _build.check_inputs(u, dt, A32, B, C, D32)
    y = torch.empty_like(u)
    with torch.cuda.device(u.device):
        code = _build.lib("probes").vct_selective_scan_batch_major(
            _build.dtype_code(u), u.data_ptr(), dt.data_ptr(), A32.data_ptr(),
            B.data_ptr(), C.data_ptr(), D32.data_ptr(), y.data_ptr(),
            L, d, n, b, _build.stream_of(u))
    _build.check("selective_scan_batch_major", code)
    _build.launches["selective_scan_batch_major"] += 1
    return y
