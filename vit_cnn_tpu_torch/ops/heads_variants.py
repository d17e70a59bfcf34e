"""Variants of head-last attention (kernel K8, residual off) for the
tuning sweep.

Ports of the JAX package's attention probes (``perf/mhst_attn_variants.py``
``kern_a/b/c/f/g/e`` and ``perf/mhst_attn_vpu.py`` ``kern_h/g``), forward
only as they are, both in ``csrc/heads_variants.cu``:

* :func:`heads_attention_mma` — V3, the matrix-unit formulations on the
  tensor cores (bf16 operands, float32 sums): per-head dots (F) or, with
  ``masked=True``, full-width dots against head-masked K and V summed over
  the heads (G, the shipped TPU kernel). P is rounded to bf16 before P.V,
  as F and G round it. bf16 only: the tensor cores would take float32
  only as TF32, which changes the numbers. A block stages a batch row's
  q, k, v token rows (TMA bulk copies where each row is 16 bytes wide and
  aligned; :func:`mma_smem`), in a persistent two-stage ring where two
  such blocks fit an SM, takes fragments by ``ldmatrix`` and
  ``mma.sync`` (m16n8k8 where a head's window is 8 channels), and for F
  over at most 80 tokens keeps every score in registers for an exact
  maximum; F at 4 heads of 16 over at most 160 tokens takes Q.K^T as one
  ``wgmma`` product per head and 64-query tile.
* :func:`heads_attention_outer` — V4, the vector-unit formulations (H's
  rank-1 score updates; C's and E's per-channel products summed per
  head) on the CUDA cores, float32 or bf16, several query rows per thread.
  Its float32 scores, P and P.V are also A's and B's arithmetic (float32
  dots on inputs cast up). One block a batch row stages the row's K and
  V as float32 by 16-byte loads (:func:`outer_smem`); q is read as
  vectors of a head's hd values and pre-scaled so that each P is one
  ``ex2.approx``; at hd <= 8 a first pass takes each row's exact maximum
  and the second accumulates with no rescale, at larger hd one pass
  rescales once per tile of 4 keys.

Both compute :func:`.attention.attention_reference_heads` with
``residual=False`` (their plain version) on q, k, v (B, n, h, hd): the
plain version for CPU tensors, the kernel for contiguous CUDA tensors, or
they raise. Shapes outside a kernel's limits raise ``ValueError`` on any
device, and so does an input that requires a gradient.
"""

from __future__ import annotations

import torch

from . import _build
from .attention import SMEM_LIMIT, attention_reference_heads

MAX_N = 512          # tokens per sequence, both variants
MAX_C = 256          # h * hd, both variants
MMA_MAX_HD = 16      # V3: one head is at most one k16 step deep
MASKED_MAX_C = 128   # V3 masked: the (16, C) float32 sums of a warp
OUTER_MAX_HD = 32    # V4: a head's q and sums in registers


def mma_smem(n: int, c: int) -> int:
    """Bytes of one V3 block: q, k and v as bf16 token rows of c rounded
    up to an odd number of 8-value units (or to 8 values, where the odd
    row would not fit), n padded to a multiple of 16, 16 values of slack
    and the staging mbarrier."""
    np_ = -(-n // 16) * 16
    w = -(-c // 8) * 8
    rows = lambda cs: 2 * (3 * np_ * cs + 16) + 8
    odd = w if (w // 8) % 2 else w + 8
    return rows(odd) if rows(odd) <= SMEM_LIMIT else rows(w)


def outer_smem(n: int, c: int) -> int:
    """Bytes of one V4 block: k and v of all heads of one batch row,
    staged as float32, each padded to 16 bytes."""
    return 2 * (-(-4 * n * c // 16) * 16)


def _check(q, k, v):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("shape mismatch: q {} k {} v {}".format(
            tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if not (k.dtype == v.dtype == q.dtype):
        raise TypeError("q, k and v must share one dtype")
    _build.forward_only("the attention variants", q, k, v)


def _limits(name, n, c, ok, smem):
    if not (1 <= n <= MAX_N and c <= MAX_C and ok):
        raise ValueError("{}: shape outside its limits (see {}); got n={}, "
                         "h*hd={}".format(name, __name__, n, c))
    if smem > SMEM_LIMIT:
        raise ValueError("{}: n={}, h*hd={} needs {} bytes of shared memory "
                         "per block, over the card's {}".format(
                             name, n, c, smem, SMEM_LIMIT))


def _launch(name, fn, q, k, v, *args):
    _build.check_inputs(q, k, v)
    b, n, h, hd = q.shape
    o = torch.empty_like(q)
    if b == 0:
        return o
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  b, n, h, hd, *args, _build.stream_of(q))
    _build.check(name, code)
    _build.launches[name] += 1
    return o


def heads_attention_mma(q, k, v, scale: float, masked: bool = False):
    """V3: softmax(q k^T scale) v per head on the tensor cores. bf16 q, k,
    v (B, n, h, hd) with hd even and <= 16, n <= 512, h * hd <= 256
    (masked: a multiple of 16 and <= 128); float32 raises TypeError."""
    _check(q, k, v)
    if q.dtype != torch.bfloat16:
        raise TypeError("V3 takes bfloat16 (the tensor cores would take "
                        "float32 as TF32); got {}".format(q.dtype))
    n, h, hd = q.shape[1:]
    c = h * hd
    _limits("heads_attention_mma", n, c,
            2 <= hd <= MMA_MAX_HD and hd % 2 == 0 and (
                not masked or (c % 16 == 0 and c <= MASKED_MAX_C)),
            mma_smem(n, c))
    if _build.use_plain(q):
        return attention_reference_heads(q, k, v, scale)
    return _launch("heads_attention_mma",
                   _build.lib("probes").vct_heads_attention_mma,
                   q, k, v, float(scale), int(masked))


def heads_attention_outer(q, k, v, scale: float):
    """V4: softmax(q k^T scale) v per head as rank-1 score updates on the
    CUDA cores. float32 or bf16 q, k, v (B, n, h, hd) with hd <= 32,
    n <= 512, h * hd <= 256."""
    _check(q, k, v)
    n, h, hd = q.shape[1:]
    _limits("heads_attention_outer", n, h * hd, 1 <= hd <= OUTER_MAX_HD,
            outer_smem(n, h * hd))
    if _build.use_plain(q):
        return attention_reference_heads(q, k, v, scale)
    lib = _build.lib("probes")
    code = _build.dtype_code(q)
    return _launch("heads_attention_outer",
                   lambda *a: lib.vct_heads_attention_outer(code, *a),
                   q, k, v, float(scale))
