"""Small-sequence attention, softmax(q k^T * scale) v.

Port of the forward of :mod:`vit_cnn_tpu.ops.attention`'s
``fused_attention`` / ``fused_attention_auto``:

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
"""

from __future__ import annotations

import torch

from . import _build

MAX_LK = 64      # keys per group the kernel stages in shared memory
MAX_DH = 256     # head width the kernel keeps in registers


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
