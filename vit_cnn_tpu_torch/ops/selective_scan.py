"""Selective state-space scan (Mamba-1 recurrence), lane-major layout.

Port of the forward of :mod:`vit_cnn_tpu.ops.selective_scan`:

* :func:`selective_scan_reference` — the plain PyTorch version: a loop
  over tokens with a float32 state. The CPU path, and what the kernel is
  held against on the card.
* :func:`selective_scan` — the public wrapper. A CPU tensor takes the
  plain version; a CUDA tensor launches kernel K1
  (``csrc/selective_scan.cu``, the counterpart of the Pallas
  ``_scan_kernel``) or raises.

Layout (the JAX kernel's ``lane_major_io``): u, dt are (L, d, b) or
(ns, L, d, b); B, C are (L, n, b) or (ns, L, n, b); A is (d, n); D is (d,).
The result has u's shape and dtype. ``reverse=True`` scans the token axis
back to front.
"""

from __future__ import annotations

import torch

from . import _build


def selective_scan_reference(u, dt, A, B, C, D, reverse: bool = False):
    """h_t = exp(dt_t A) h_{t-1} + (dt_t u_t) B_t; y_t = C_t . h_t + D u_t,
    in float32, returned in u's dtype."""
    squeeze = u.dim() == 3
    if squeeze:
        u, dt, B, C = (x.unsqueeze(0) for x in (u, dt, B, C))
    uf, dtf, Bf, Cf = (x.float() for x in (u, dt, B, C))
    At = A.float()[None, :, :, None]                     # (1, d, n, 1)
    Dv = D.float()[None, :, None]                        # (1, d, 1)
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


def selective_scan(u, dt, A, B, C, D, reverse: bool = False):
    """The scan on u's device: plain version on the CPU, K1 on CUDA."""
    if _build.use_plain(u):
        return selective_scan_reference(u, dt, A, B, C, D, reverse)
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
    A = A.float().contiguous()
    D = D.float().contiguous()
    _build.check_inputs(u, dt, A, B, C, D)
    ns = u.shape[0] if u.dim() == 4 else 1
    L, _, b = u.shape[-3:]
    y = torch.empty_like(u)
    with torch.cuda.device(u.device):
        code = _build.lib().vct_selective_scan(
            _build.dtype_code(u), u.data_ptr(), dt.data_ptr(), A.data_ptr(),
            B.data_ptr(), C.data_ptr(), D.data_ptr(), y.data_ptr(),
            ns, L, d, n, b, int(reverse), _build.stream_of(u))
    _build.check("selective_scan", code)
    _build.launches["selective_scan"] += 1
    return y
