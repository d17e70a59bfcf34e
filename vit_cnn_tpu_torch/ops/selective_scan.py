"""Selective state-space scan (Mamba-1 recurrence), lane-major layout.

Port of :mod:`vit_cnn_tpu.ops.selective_scan`:

* :func:`selective_scan_reference` — the plain PyTorch version: a loop
  over tokens with a float32 state. The CPU path (autograd differentiates
  it there), and what the kernel is held against on the card.
* :func:`selective_scan_backward_reference` — its plain adjoint
  (autograd through the plain forward), what K5 is held against.
* :func:`selective_scan` — the public wrapper. A CPU tensor takes the
  plain version; a CUDA tensor runs an autograd Function whose forward is
  kernel K1 (``csrc/selective_scan.cu``, the counterpart of the Pallas
  ``_scan_kernel``) and whose backward is kernel K5
  (``csrc/selective_scan_bwd.cu``, the counterpart of
  ``_scan_bwd_kernel``), or raises.

Layout (the JAX kernel's ``lane_major_io``): u, dt are (L, d, b) or
(ns, L, d, b); B, C are (L, n, b) or (ns, L, n, b); A is (d, n); D is (d,).
The result has u's shape and dtype. ``reverse=True`` scans the token axis
back to front. Gradients come back in their inputs' dtypes, computed in
float32, as ``_pallas_backward`` returns them.
"""

from __future__ import annotations

import torch

from . import _build


def selective_scan_reference(u, dt, A, B, C, D, reverse: bool = False):
    """h_t = exp(dt_t A) h_{t-1} + (dt_t u_t) B_t; y_t = C_t . h_t + D u_t,
    in float32 (float64 for float64 u), returned in u's dtype."""
    squeeze = u.dim() == 3
    if squeeze:
        u, dt, B, C = (x.unsqueeze(0) for x in (u, dt, B, C))
    f = _build.wide(u)
    uf, dtf, Bf, Cf = (x.to(f) for x in (u, dt, B, C))
    At = A.to(f)[None, :, :, None]                       # (1, d, n, 1)
    Dv = D.to(f)[None, :, None]                          # (1, d, 1)
    ns, L, d, b = uf.shape
    h = uf.new_zeros((ns, d, At.shape[2], b))
    ys = [None] * L
    for t in (range(L - 1, -1, -1) if reverse else range(L)):
        dA = torch.exp(dtf[:, t, :, None, :] * At)       # (ns, d, n, b)
        dBu = (dtf[:, t] * uf[:, t])[:, :, None, :] * Bf[:, t, None]
        h = dA * h + dBu
        ys[t] = (h * Cf[:, t, None]).sum(dim=2) + Dv * uf[:, t]
    y = torch.stack(ys, dim=1).to(u.dtype)
    return y[0] if squeeze else y


def selective_scan_backward_reference(u, dt, A, B, C, D, g,
                                      reverse: bool = False):
    """(du, ddt, dA, dB, dC, dD) of the plain scan for the cotangent g:
    autograd through :func:`selective_scan_reference`, each gradient in
    its input's dtype."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in (u, dt, A, B, C, D)]
        y = selective_scan_reference(*leaves, reverse=reverse)
        return torch.autograd.grad(y, leaves, g)


def _check(u, dt, A, B, C, D):
    if u.dim() not in (3, 4) or dt.shape != u.shape:
        raise ValueError("u/dt must be (L, d, b) or (ns, L, d, b) alike")
    d, n = A.shape
    if (u.shape[-2] != d or B.shape != C.shape
            or B.shape[:-2] != u.shape[:-2] or B.shape[-2:] != (n, u.shape[-1])
            or D.shape != (d,)):
        raise ValueError("shape mismatch: u {} B {} C {} A {} D {}".format(
            tuple(u.shape), tuple(B.shape), tuple(C.shape), tuple(A.shape),
            tuple(D.shape)))
    if not (dt.dtype == B.dtype == C.dtype == u.dtype):
        raise TypeError("u, dt, B and C must share one dtype")


def _dims(u, A):
    ns = u.shape[0] if u.dim() == 4 else 1
    L, d, b = u.shape[-3:]
    return ns, L, d, A.shape[1], b


def _forward_kernel(u, dt, A, B, C, D, reverse):
    """K1: y for CUDA tensors."""
    A32, D32 = A.float().contiguous(), D.float().contiguous()
    _build.check_inputs(u, dt, A32, B, C, D32)
    ns, L, d, n, b = _dims(u, A)
    y = torch.empty_like(u)
    with torch.cuda.device(u.device):
        code = _build.lib().vct_selective_scan(
            _build.dtype_code(u), u.data_ptr(), dt.data_ptr(), A32.data_ptr(),
            B.data_ptr(), C.data_ptr(), D32.data_ptr(), y.data_ptr(),
            ns, L, d, n, b, int(reverse), _build.stream_of(u))
    _build.check("selective_scan", code)
    _build.launches["selective_scan"] += 1
    return y


def selective_scan_backward(u, dt, A, B, C, D, g, reverse: bool = False):
    """K5: (du, ddt, dA, dB, dC, dD) for CUDA tensors, each in its input's
    dtype; the plain adjoint for CPU tensors."""
    if _build.use_plain(u):
        return selective_scan_backward_reference(u, dt, A, B, C, D, g,
                                                 reverse)
    _check(u, dt, A, B, C, D)
    g = g.to(u.dtype).contiguous()
    A32, D32 = A.float().contiguous(), D.float().contiguous()
    _build.check_inputs(u, dt, A32, B, C, D32, g)
    ns, L, d, n, b = _dims(u, A)
    du, ddt = torch.empty_like(u), torch.empty_like(u)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    dA = torch.empty((d, n), dtype=torch.float32, device=u.device)
    dD = torch.empty((d,), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        work = _build.workspace("vct_selective_scan_bwd", ns, L, d, n, b,
                                device=u.device)
        code = _build.lib().vct_selective_scan_bwd(
            _build.dtype_code(u), u.data_ptr(), dt.data_ptr(), A32.data_ptr(),
            B.data_ptr(), C.data_ptr(), D32.data_ptr(), g.data_ptr(),
            du.data_ptr(), ddt.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            dA.data_ptr(), dD.data_ptr(), work.data_ptr(),
            ns, L, d, n, b, int(reverse), _build.stream_of(u))
    _build.check("selective_scan_backward", code)
    _build.launches["selective_scan_backward"] += 1
    return du, ddt, dA.to(A.dtype), dB, dC, dD.to(D.dtype)


class _SelectiveScan(torch.autograd.Function):
    """Forward K1, backward K5; only the inputs are saved (the kernel
    recomputes the state, as the Pallas backward does)."""

    @staticmethod
    def forward(ctx, u, dt, A, B, C, D, reverse):
        ctx.reverse = reverse
        ctx.save_for_backward(u, dt, A, B, C, D)
        return _forward_kernel(u, dt, A, B, C, D, reverse)

    @staticmethod
    def backward(ctx, g):
        grads = selective_scan_backward(*ctx.saved_tensors, g,
                                        reverse=ctx.reverse)
        return (*grads, None)


def selective_scan(u, dt, A, B, C, D, reverse: bool = False):
    """The scan on u's device: plain version on the CPU, K1 (forward) and
    K5 (backward) on CUDA."""
    if _build.use_plain(u):
        return selective_scan_reference(u, dt, A, B, C, D, reverse)
    _check(u, dt, A, B, C, D)
    return _SelectiveScan.apply(u, dt, A, B, C, D, bool(reverse))
