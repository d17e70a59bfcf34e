"""Directional-stream kernels of the multi-directional Mamba layer.

Port of the forward of :mod:`vit_cnn_tpu.ops.dirstream`, lane-major
(L, d, b) layout:

* :func:`dir_conv_silu` — for every static token order, gather the rows
  of u, then the causal (forward stream) or anti-causal (reverse stream)
  depthwise k-tap conv, bias and SiLU. Kernel K2 (``csrc/dirstream.cu``,
  the counterpart of the Pallas ``_dir_conv_kernel``).
* :func:`inv_perm_weighted_sum` — the inverse: every stream's rows put
  back in token order, weighted and summed in float32. Kernel K3 (the
  counterpart of ``_inv_sum_kernel``).

Each wrapper takes its plain PyTorch version (``*_reference``) for a CPU
tensor and launches its kernel for a CUDA tensor. Orders are int32
tensors on the activations' device: ``orders`` / ``inv_orders`` are
(nb, L) and ``rev_rows`` (nr,) lists the orders that also run in reverse.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build


def _conv_silu(pu, cw, cb, reverse: bool):
    """Depthwise k-tap conv over axis 1 of (N, L, d, b) as shifted adds,
    plus bias and SiLU: tap j reads offset -(k-1-j) (causal) or +(k-1-j)
    (anti-causal), zeros outside the sequence."""
    L = pu.shape[1]
    k = cw.shape[0]
    acc = torch.zeros_like(pu) + cb[:, None]
    for j in range(k):
        s = min(k - 1 - j, L)
        if s == 0:
            seg = pu
        else:
            pad = pu.new_zeros((pu.shape[0], s) + tuple(pu.shape[2:]))
            seg = (torch.cat([pu[:, s:], pad], dim=1) if reverse
                   else torch.cat([pad, pu[:, :L - s]], dim=1))
        acc = acc + cw[j][:, None] * seg
    return F.silu(acc)


def dir_conv_silu_reference(u, cw, cb, orders, rev_rows):
    """u (L, d, b); cw (k, d); cb (d,). Returns (fwd (nb, L, d, b),
    rev (nr, L, d, b)) in u's dtype, computed in float32."""
    pu = u.float()[orders.long()]                        # (nb, L, d, b)
    cw, cb = cw.float(), cb.float()
    fwd = _conv_silu(pu, cw, cb, reverse=False)
    rev = _conv_silu(pu[rev_rows.long()], cw, cb, reverse=True)
    return fwd.to(u.dtype), rev.to(u.dtype)


def inv_perm_weighted_sum_reference(y_fwd, y_rev, w_fwd, w_rev, inv_orders,
                                    rev_rows):
    """out[t] = sum_i w_fwd[i] y_fwd[i][inv_i[t]]
    + sum_j w_rev[j] y_rev[j][inv_{rev_rows[j]}[t]], float32 accumulation,
    returned in y_fwd's dtype."""
    inv = inv_orders.long()
    wf, wr = w_fwd.float(), w_rev.float()
    out = torch.zeros(y_fwd.shape[1:], dtype=torch.float32,
                      device=y_fwd.device)
    for i in range(y_fwd.shape[0]):
        out = out + wf[i] * y_fwd[i][inv[i]].float()
    for j, r in enumerate(rev_rows.tolist()):
        out = out + wr[j] * y_rev[j][inv[r]].float()
    return out.to(y_fwd.dtype)


def _int_table(t):
    if t.dtype != torch.int32:
        raise TypeError("order tables must be int32, got {}".format(t.dtype))
    return t


def dir_conv_silu(u, cw, cb, orders, rev_rows):
    """Permute + causal/anti-causal conv + SiLU for every stream, on u's
    device: plain version on the CPU, K2 on CUDA."""
    if _build.use_plain(u):
        return dir_conv_silu_reference(u, cw, cb, orders, rev_rows)
    L, d, b = u.shape
    k = cw.shape[0]
    nb, nr = orders.shape[0], rev_rows.shape[0]
    if orders.shape != (nb, L) or cw.shape != (k, d) or cb.shape != (d,):
        raise ValueError("shape mismatch: u {} cw {} cb {} orders {}".format(
            tuple(u.shape), tuple(cw.shape), tuple(cb.shape),
            tuple(orders.shape)))
    cw = cw.float().contiguous()
    cb = cb.float().contiguous()
    orders, rev_rows = _int_table(orders), _int_table(rev_rows)
    _build.check_inputs(u, cw, cb, orders, rev_rows)
    fwd = torch.empty((nb, L, d, b), dtype=u.dtype, device=u.device)
    rev = torch.empty((nr, L, d, b), dtype=u.dtype, device=u.device)
    with torch.cuda.device(u.device):
        code = _build.lib().vct_dir_conv_silu(
            _build.dtype_code(u), u.data_ptr(), cw.data_ptr(), cb.data_ptr(),
            orders.data_ptr(), rev_rows.data_ptr() if nr else None,
            fwd.data_ptr(), rev.data_ptr() if nr else None,
            L, d, b, nb, nr, k, _build.stream_of(u))
    _build.check("dir_conv_silu", code)
    _build.launches["dir_conv_silu"] += 1
    return fwd, rev


def inv_perm_weighted_sum(y_fwd, y_rev, w_fwd, w_rev, inv_orders, rev_rows):
    """Inverse permute + per-stream weight + stream sum, on y_fwd's device:
    plain version on the CPU, K3 on CUDA. Returns (L, d, b)."""
    if _build.use_plain(y_fwd):
        return inv_perm_weighted_sum_reference(y_fwd, y_rev, w_fwd, w_rev,
                                               inv_orders, rev_rows)
    nb, L, d, b = y_fwd.shape
    nr = y_rev.shape[0]
    if (y_rev.shape[1:] != y_fwd.shape[1:] or inv_orders.shape != (nb, L)
            or rev_rows.shape != (nr,) or w_fwd.shape != (nb,)
            or w_rev.shape != (nr,)):
        raise ValueError("shape mismatch: y_fwd {} y_rev {} inv {}".format(
            tuple(y_fwd.shape), tuple(y_rev.shape), tuple(inv_orders.shape)))
    if y_rev.dtype != y_fwd.dtype:
        raise TypeError("y_fwd and y_rev must share one dtype")
    w_fwd = w_fwd.float().contiguous()
    w_rev = w_rev.float().contiguous()
    inv_orders, rev_rows = _int_table(inv_orders), _int_table(rev_rows)
    _build.check_inputs(y_fwd, y_rev, w_fwd, w_rev, inv_orders, rev_rows)
    out = torch.empty((L, d, b), dtype=y_fwd.dtype, device=y_fwd.device)
    with torch.cuda.device(y_fwd.device):
        code = _build.lib().vct_inv_perm_weighted_sum(
            _build.dtype_code(y_fwd), y_fwd.data_ptr(),
            y_rev.data_ptr() if nr else None, w_fwd.data_ptr(),
            w_rev.data_ptr() if nr else None, inv_orders.data_ptr(),
            rev_rows.data_ptr() if nr else None, out.data_ptr(),
            L, d, b, nb, nr, _build.stream_of(y_fwd))
    _build.check("inv_perm_weighted_sum", code)
    _build.launches["inv_perm_weighted_sum"] += 1
    return out
