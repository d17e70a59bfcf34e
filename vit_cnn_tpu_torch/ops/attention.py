"""Small-sequence attention, softmax(q k^T * scale) v.

Port of the forwards of :mod:`vit_cnn_tpu.ops.attention`. Folded groups
(the flagship's NonLocal block):

* :func:`attention_reference` — the plain PyTorch version, float32
  scores, returned in q's dtype.
* :func:`fused_attention` — (G, Lq, dh) x (G, Lk, dh): the plain version
  for a CPU tensor; for a CUDA tensor an autograd Function whose forward
  is kernel K4 (``csrc/attention.cu``, the counterpart of the Pallas
  kernel built by ``_make_kernel``) and whose backward differentiates the
  plain formula, as the JAX package's ``_fa_bwd`` does (that backward is
  no TPU kernel, so plain PyTorch is its port).
* :func:`fused_attention_auto` — also takes (B, H, L, dh), folding B and H
  into G, and returns the rank it got.

Head-last attention over many small heads (the transformer zoo):

* :func:`attention_reference_heads` — q, k, v (B, n, h, hd), float32
  scores, optionally adding q to every output row but the first (MViT
  residual pooling; row 0 is the CLS token).
* :func:`fused_attention_heads` (``_auto``: the same; the JAX package's
  TPU gate and VMEM block choice have no counterpart here) — kernel K8
  (``csrc/heads_attention.cu``, the counterpart of ``_make_heads_kernel``)
  for CUDA tensors, the plain version for CPU tensors. In bf16 K8 runs on
  the tensor cores with P rounded to bf16 before P.V, as the TPU kernel
  rounds it; in float32 on the CUDA cores with a float32 P. Each block
  takes one batch row and a group of heads (:func:`_heads_group`).
* :func:`ln_groups_reference` — flax LayerNorm over each hd-sized channel
  group of (B, n, c): float32 statistics, fast variance, eps 1e-5, (hd,)
  scale and bias shared by the groups.
* :func:`pooled_attention_reference` — MHST's pooled-attention tail: the
  group LN of q, k and v, then head-last attention with the +q(post-LN)
  residual.
* :func:`pooled_heads_attention` (``_auto`` takes the (scale, bias) pairs
  as the JAX one does) — kernel K9 (``_make_pooled_kernel``'s
  counterpart, the LN as a prologue of K8's attention) for CUDA tensors.
  On the TPU that kernel is gated off because the TPU compiler
  miscompiled it; on the card it is the path. In float32 K9 takes the LN
  statistics in float64: the fast variance cancels for a group whose mean
  is large beside its spread, and any two float32 summation orders then
  differ by ~1e-3 in the normalised values (the plain version too, against
  the exact value), so K9 is held to the plain version run in float64. In
  bf16 it takes them in float32, as the TPU kernel and the plain version
  do: the values are rounded to bf16 (a relative step of 2^-8) right after.

The backward of K8 and K9 differentiates the plain formula, as the JAX
package's ``_fah_bwd`` and ``_pha_bwd`` do.
"""

from __future__ import annotations

import torch

from ..utils.profiling import span
from . import _build

MAX_LK = 64      # keys per group the kernel stages in shared memory
MAX_DH = 256     # head width the kernel keeps in registers
HEADS_MAX_N = 512    # K8 / K9: tokens per sequence
HEADS_MAX_HD = 32    # K8 / K9: one head's width (a warp's lanes)
HEADS_MAX_C = 256    # K8 / K9: h * hd
SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may take
HEADS_WARPS = 8      # warps per block of K8 and K9 (csrc kThreads / 32)
# profiler ranges around the plain backward of K8 and K9
# (tools/profile_train.py reads their device time)
HEADS_BACKWARD = "K8 plain backward"
POOLED_BACKWARD = "K9 plain backward"


def attention_reference(q, k, v, scale: float):
    f = _build.wide(q)
    s = torch.einsum("gid,gjd->gij", q.to(f), k.to(f)) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("gij,gjd->gid", p, v.to(f)).to(q.dtype)


def _attention_kernel(q, k, v, scale):
    """K4 for CUDA tensors."""
    G, lq, dh = q.shape
    lk = k.shape[1]
    _build.check_inputs(q, k, v)
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        code = _build.lib().vct_attention(
            _build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), G, lq, lk, dh, float(scale), _build.stream_of(q))
    _build.check("fused_attention", code)
    _build.launches["fused_attention"] += 1
    return o


class _FusedAttention(torch.autograd.Function):
    """Forward K4; backward recomputes the plain formula (``_fa_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v)
        return _attention_kernel(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in ctx.saved_tensors]
            o = attention_reference(*leaves, ctx.scale)
            return (*torch.autograd.grad(o, leaves, g), None)


def fused_attention(q, k, v, scale: float):
    """softmax(q k^T * scale) v on q's device: plain version on the CPU,
    K4 on CUDA. q (G, Lq, dh); k, v (G, Lk, dh)."""
    if _build.use_plain(q):
        return attention_reference(q, k, v, scale)
    G, lq, dh = q.shape
    lk = k.shape[1]
    if k.shape != (G, lk, dh) or v.shape != k.shape:
        raise ValueError("shape mismatch: q {} k {} v {}".format(
            tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if lk > MAX_LK or dh > MAX_DH:
        raise ValueError("K4 takes Lk <= {} and dh <= {}, got {} and {}"
                         .format(MAX_LK, MAX_DH, lk, dh))
    if not (k.dtype == v.dtype == q.dtype):
        raise TypeError("q, k and v must share one dtype")
    return _FusedAttention.apply(q, k, v, float(scale))


def fused_attention_auto(q, k, v, scale: float):
    """Accepts (G, L, dh) or (B, H, L, dh); returns the rank it got."""
    if q.dim() == 4:
        b, h, lq, dh = q.shape
        fold = lambda t: t.reshape(b * h, t.shape[2], t.shape[3])
        o = fused_attention(fold(q), fold(k), fold(v), scale)
        return o.reshape(b, h, lq, dh)
    return fused_attention(q, k, v, scale)


def attention_reference_heads(q, k, v, scale: float,
                              residual: bool = False):
    """Head-last formula: q, k, v (B, n, h, hd) -> (B, n, h, hd), computed
    in float32 and rounded once to q's dtype."""
    f = _build.wide(q)
    qf = q.to(f)
    s = torch.einsum("bihd,bjhd->bhij", qf, k.to(f)) * scale
    o = torch.einsum("bhij,bjhd->bihd", torch.softmax(s, dim=-1), v.to(f))
    if residual:
        o[:, 1:] += qf[:, 1:]
    return o.to(q.dtype)


def ln_groups_reference(x, gamma, beta, hd: int, eps: float = 1e-5):
    """LayerNorm over the trailing hd-sized channel groups of (B, n, c)."""
    b, n, c = x.shape
    f = _build.wide(x)
    xf = x.to(f).reshape(b, n, c // hd, hd)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0)
    y = (xf - mu) * torch.rsqrt(var + eps) * gamma.to(f) + beta.to(f)
    return y.reshape(b, n, c).to(x.dtype)


def pooled_attention_reference(q, k, v, ln_q, ln_k, ln_v, h: int,
                               scale: float, residual: bool = True):
    """q, k, v (B, n, c); ln_* = (scale, bias), each (c // h,)."""
    b, n, c = q.shape
    hd = c // h
    heads = lambda t, ln: ln_groups_reference(t, *ln, hd).reshape(
        b, n, h, hd)
    o = attention_reference_heads(heads(q, ln_q), heads(k, ln_k),
                                  heads(v, ln_v), scale, residual)
    return o.reshape(b, n, c)


def _heads_smem(n: int, heads: int, hd: int, dtype=torch.float32) -> int:
    """Shared memory of one K8 or K9 block of ``heads`` heads (the
    ``smem_bytes`` / ``smem_bf16`` of csrc/heads_attention.cu). float32:
    q, k and v in float32 rows padded to an odd width, and one row of
    scores per warp. bf16: q, k and v as bf16 token rows of the block's
    heads, each head padded to a multiple of 8 channels, the row to an odd
    number of 8-channel units, and n to a multiple of 16."""
    if dtype == torch.bfloat16:
        width = heads * -(-hd // 8) * 8
        row = width if (width // 8) % 2 else width + 8
        return 2 * 3 * (-(-n // 16) * 16) * row
    return 4 * (3 * heads * n * (hd | 1) + HEADS_WARPS * n)


def _check_heads_shape(n, h, hd, block_heads, dtype=torch.float32):
    if not (1 <= n <= HEADS_MAX_N and 1 <= hd <= HEADS_MAX_HD
            and 1 <= h * hd <= HEADS_MAX_C):
        raise ValueError(
            "K8 / K9 take n <= {}, hd <= {} and h * hd <= {}; got n={}, "
            "h={}, hd={}".format(HEADS_MAX_N, HEADS_MAX_HD, HEADS_MAX_C, n,
                                 h, hd))
    smem = _heads_smem(n, block_heads, hd, dtype)
    if smem > SMEM_LIMIT:
        raise ValueError("n={}, h={}, hd={} needs {} bytes of shared memory "
                         "per block, over the card's {}".format(
                             n, block_heads, hd, smem, SMEM_LIMIT))


def _heads_group(n: int, h: int, hd: int, dtype, pooled: bool) -> int:
    """Heads per block of K8 (``pooled`` False) or K9, after checking the
    shape. float32: one for K8 and all h for K9 (their layouts are fixed).
    bf16: the most heads whose staging fits in shared memory, spread evenly
    over the fewest blocks per batch row; one head always fits."""
    if dtype != torch.bfloat16:
        group = h if pooled else 1
    else:
        _check_heads_shape(n, h, hd, 1, dtype)
        most = next(g for g in range(h, 0, -1)
                    if _heads_smem(n, g, hd, dtype) <= SMEM_LIMIT)
        group = -(-h // -(-h // most))
    _check_heads_shape(n, h, hd, group, dtype)
    return group


def _heads_kernel(q, k, v, scale, residual, group):
    """K8 for CUDA tensors, ``group`` heads per block. q, k and v may be
    strided views (the split of a fused qkv projection): each needs unit
    channel stride, head stride hd, and the same batch and token strides
    as the others."""
    b, n, h, hd = q.shape
    for t in (k, v):
        if t.device != q.device:
            raise ValueError("tensors on different devices: {} vs {}".format(
                q.device, t.device))
        if t.stride() != q.stride():
            raise ValueError("q, k and v must share their strides")
    if q.stride(3) != 1 or q.stride(2) != hd:
        raise ValueError("K8 needs each token's heads contiguous, (h, hd) "
                         "strides ({}, 1); got {}".format(hd, q.stride()))
    o = torch.empty((b, n, h, hd), dtype=q.dtype, device=q.device)
    if b == 0:
        return o
    with torch.cuda.device(q.device):
        code = _build.lib().vct_heads_attention(
            _build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), b, n, h, hd, q.stride(0), q.stride(1),
            float(scale), int(residual), group, _build.stream_of(q))
    _build.check("fused_attention_heads", code)
    _build.launches["fused_attention_heads"] += 1
    return o


class _HeadsAttention(torch.autograd.Function):
    """Forward K8; backward recomputes the plain formula (``_fah_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, residual, group):
        ctx.scale, ctx.residual = scale, residual
        ctx.save_for_backward(q, k, v)
        return _heads_kernel(q, k, v, scale, residual, group)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad(), span(HEADS_BACKWARD):
            leaves = [x.detach().requires_grad_() for x in ctx.saved_tensors]
            o = attention_reference_heads(*leaves, ctx.scale, ctx.residual)
            return (*torch.autograd.grad(o, leaves, g), None, None, None)


def fused_attention_heads(q, k, v, scale: float, residual: bool = False):
    """Head-last attention on q's device: plain version on the CPU, K8 on
    CUDA. q, k, v (B, n, h, hd) of one dtype."""
    if _build.use_plain(q):
        return attention_reference_heads(q, k, v, scale, residual)
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("shape mismatch: q {} k {} v {}".format(
            tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if not (k.dtype == v.dtype == q.dtype):
        raise TypeError("q, k and v must share one dtype")
    group = _heads_group(*q.shape[1:], q.dtype, pooled=False)
    return _HeadsAttention.apply(q, k, v, float(scale), bool(residual),
                                 group)


fused_attention_heads_auto = fused_attention_heads


def _pooled_kernel(q, k, v, ln, h, scale, residual, group):
    """K9 for contiguous CUDA tensors, ``group`` heads per block; ``ln``
    the six (hd,) LN vectors."""
    b, n, c = q.shape
    _build.check_inputs(q, k, v)
    ln = torch.stack([p.float() for p in ln]).contiguous()
    if ln.device != q.device:
        raise ValueError("LN parameters on {}, q on {}".format(ln.device,
                                                               q.device))
    o = torch.empty_like(q)
    if b == 0:
        return o
    with torch.cuda.device(q.device):
        code = _build.lib().vct_pooled_attention(
            _build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            ln.data_ptr(), o.data_ptr(), b, n, h, c // h, float(scale),
            int(residual), group, _build.stream_of(q))
    _build.check("pooled_heads_attention", code)
    _build.launches["pooled_heads_attention"] += 1
    return o


class _PooledAttention(torch.autograd.Function):
    """Forward K9; backward recomputes the plain composition
    (``_pha_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, gq, bq, gk, bk, gv, bv, h, scale, residual,
                group):
        ctx.h, ctx.scale, ctx.residual = h, scale, residual
        ctx.save_for_backward(q, k, v, gq, bq, gk, bk, gv, bv)
        return _pooled_kernel(q, k, v, (gq, bq, gk, bk, gv, bv), h, scale,
                              residual, group)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad(), span(POOLED_BACKWARD):
            leaves = [x.detach().requires_grad_() for x in ctx.saved_tensors]
            q, k, v, gq, bq, gk, bk, gv, bv = leaves
            o = pooled_attention_reference(q, k, v, (gq, bq), (gk, bk),
                                           (gv, bv), ctx.h, ctx.scale,
                                           ctx.residual)
            return (*torch.autograd.grad(o, leaves, g), None, None, None,
                    None)


def pooled_heads_attention(q, k, v, gq, bq, gk, bk, gv, bv, h: int,
                           scale: float, residual: bool = True):
    """Group LN of q, k and v, head-last attention over h heads and the
    +q(post-LN) residual on q's device: plain version on the CPU, K9 on
    CUDA. q, k, v (B, n, c); the LN scales and biases (c // h,)."""
    if _build.use_plain(q):
        return pooled_attention_reference(q, k, v, (gq, bq), (gk, bk),
                                          (gv, bv), h, scale, residual)
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("shape mismatch: q {} k {} v {}".format(
            tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if not (k.dtype == v.dtype == q.dtype):
        raise TypeError("q, k and v must share one dtype")
    b, n, c = q.shape
    if c % h:
        raise ValueError("{} channels do not split into {} heads".format(c,
                                                                         h))
    hd = c // h
    if any(p.shape != (hd,) for p in (gq, bq, gk, bk, gv, bv)):
        raise ValueError("each LN scale and bias must be ({},)".format(hd))
    group = _heads_group(n, h, hd, q.dtype, pooled=True)
    return _PooledAttention.apply(q, k, v, gq, bq, gk, bk, gv, bv, int(h),
                                  float(scale), bool(residual), group)


def pooled_heads_attention_auto(q, k, v, ln_q, ln_k, ln_v, h: int,
                                scale: float, residual: bool = True):
    """:func:`pooled_heads_attention` with the (scale, bias) pairs."""
    return pooled_heads_attention(q, k, v, *ln_q, *ln_k, *ln_v, h, scale,
                                  residual)
