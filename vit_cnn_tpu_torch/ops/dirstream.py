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
tensor, which autograd differentiates there. For a CUDA tensor it runs an
autograd Function whose forward is its kernel and whose backward is the
adjoint kernel: K6 (``csrc/dirstream_bwd.cu``, the counterpart of
``_dir_conv_adj_kernel``) for :func:`dir_conv_silu`, K7 (the counterpart
of ``_inv_sum_adj_kernel``) for :func:`inv_perm_weighted_sum`. Each
adjoint has a plain version too (``*_backward_reference``, autograd
through the plain forward). Orders are int32 tensors on the activations'
device and get no gradient: ``orders`` / ``inv_orders`` are (nb, L) and
``rev_rows`` (nr,) lists the orders that also run in reverse. Gradients
come back in their inputs' dtypes, accumulated in float32.
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
    rev (nr, L, d, b)) in u's dtype, computed in float32 (float64 for
    float64 u)."""
    f = _build.wide(u)
    pu = u.to(f)[orders.long()]                          # (nb, L, d, b)
    cw, cb = cw.to(f), cb.to(f)
    fwd = _conv_silu(pu, cw, cb, reverse=False)
    rev = _conv_silu(pu[rev_rows.long()], cw, cb, reverse=True)
    return fwd.to(u.dtype), rev.to(u.dtype)


def inv_perm_weighted_sum_reference(y_fwd, y_rev, w_fwd, w_rev, inv_orders,
                                    rev_rows):
    """out[t] = sum_i w_fwd[i] y_fwd[i][inv_i[t]]
    + sum_j w_rev[j] y_rev[j][inv_{rev_rows[j]}[t]], float32 accumulation
    (float64 for float64 y_fwd), returned in y_fwd's dtype."""
    inv = inv_orders.long()
    f = _build.wide(y_fwd)
    wf, wr = w_fwd.to(f), w_rev.to(f)
    out = torch.zeros(y_fwd.shape[1:], dtype=f, device=y_fwd.device)
    for i in range(y_fwd.shape[0]):
        out = out + wf[i] * y_fwd[i][inv[i]].to(f)
    for j, r in enumerate(rev_rows.tolist()):
        out = out + wr[j] * y_rev[j][inv[r]].to(f)
    return out.to(y_fwd.dtype)


def dir_conv_silu_backward_reference(u, cw, cb, orders, rev_rows, gf, gr):
    """(du, dcw, dcb) of :func:`dir_conv_silu_reference` for the stream
    cotangents gf (nb, L, d, b) and gr (nr, L, d, b)."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in (u, cw, cb)]
        fwd, rev = dir_conv_silu_reference(*leaves, orders, rev_rows)
        return torch.autograd.grad((fwd, rev), leaves, (gf, gr),
                                   allow_unused=True)


def inv_perm_weighted_sum_backward_reference(y_fwd, y_rev, w_fwd, w_rev,
                                             inv_orders, rev_rows, g):
    """(dy_fwd, dy_rev, dw_fwd, dw_rev) of
    :func:`inv_perm_weighted_sum_reference` for the cotangent g (L, d, b)."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_()
                  for x in (y_fwd, y_rev, w_fwd, w_rev)]
        out = inv_perm_weighted_sum_reference(*leaves, inv_orders, rev_rows)
        grads = torch.autograd.grad(out, leaves, g, allow_unused=True)
    return tuple(torch.zeros_like(x) if d is None else d
                 for x, d in zip(leaves, grads))


def _int_table(t):
    if t.dtype != torch.int32:
        raise TypeError("order tables must be int32, got {}".format(t.dtype))
    return t


def _check_conv(u, cw, cb, orders, rev_rows):
    L, d, b = u.shape
    k = cw.shape[0]
    if (orders.shape != (orders.shape[0], L) or cw.shape != (k, d)
            or cb.shape != (d,)):
        raise ValueError("shape mismatch: u {} cw {} cb {} orders {}".format(
            tuple(u.shape), tuple(cw.shape), tuple(cb.shape),
            tuple(orders.shape)))
    return _int_table(orders), _int_table(rev_rows)


def _check_sum(y_fwd, y_rev, w_fwd, w_rev, inv_orders, rev_rows):
    nb, L, d, b = y_fwd.shape
    nr = y_rev.shape[0]
    if (y_rev.shape[1:] != y_fwd.shape[1:] or inv_orders.shape != (nb, L)
            or rev_rows.shape != (nr,) or w_fwd.shape != (nb,)
            or w_rev.shape != (nr,)):
        raise ValueError("shape mismatch: y_fwd {} y_rev {} inv {}".format(
            tuple(y_fwd.shape), tuple(y_rev.shape), tuple(inv_orders.shape)))
    if y_rev.dtype != y_fwd.dtype:
        raise TypeError("y_fwd and y_rev must share one dtype")
    return _int_table(inv_orders), _int_table(rev_rows)


def _opt(t, nonempty):
    return t.data_ptr() if nonempty else None


def _conv_kernel(u, cw, cb, orders, rev_rows):
    """K2 for CUDA tensors."""
    L, d, b = u.shape
    k = cw.shape[0]
    nb, nr = orders.shape[0], rev_rows.shape[0]
    cw = cw.float().contiguous()
    cb = cb.float().contiguous()
    _build.check_inputs(u, cw, cb, orders, rev_rows)
    fwd = torch.empty((nb, L, d, b), dtype=u.dtype, device=u.device)
    rev = torch.empty((nr, L, d, b), dtype=u.dtype, device=u.device)
    with torch.cuda.device(u.device):
        code = _build.lib().vct_dir_conv_silu(
            _build.dtype_code(u), u.data_ptr(), cw.data_ptr(), cb.data_ptr(),
            orders.data_ptr(), _opt(rev_rows, nr), fwd.data_ptr(),
            _opt(rev, nr), L, d, b, nb, nr, k, _build.stream_of(u))
    _build.check("dir_conv_silu", code)
    _build.launches["dir_conv_silu"] += 1
    return fwd, rev


def dir_conv_silu_backward(u, cw, cb, orders, rev_rows, gf, gr):
    """K6: (du, dcw, dcb) for CUDA tensors, each in its input's dtype; the
    plain adjoint for CPU tensors."""
    if _build.use_plain(u):
        return dir_conv_silu_backward_reference(u, cw, cb, orders, rev_rows,
                                                gf, gr)
    orders, rev_rows = _check_conv(u, cw, cb, orders, rev_rows)
    L, d, b = u.shape
    k = cw.shape[0]
    nb, nr = orders.shape[0], rev_rows.shape[0]
    if gf.shape != (nb, L, d, b) or gr.shape != (nr, L, d, b):
        raise ValueError("cotangents {} / {} do not match the streams".format(
            tuple(gf.shape), tuple(gr.shape)))
    gf = gf.to(u.dtype).contiguous()
    gr = gr.to(u.dtype).contiguous()
    cw32 = cw.float().contiguous()
    cb32 = cb.float().contiguous()
    _build.check_inputs(u, cw32, cb32, orders, rev_rows, gf, gr)
    du = torch.empty_like(u)
    dcw = torch.empty((k, d), dtype=torch.float32, device=u.device)
    dcb = torch.empty((d,), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        work = _build.workspace("vct_dir_conv_silu_bwd", d, b, k,
                                device=u.device)
        code = _build.lib().vct_dir_conv_silu_bwd(
            _build.dtype_code(u), u.data_ptr(), cw32.data_ptr(),
            cb32.data_ptr(), orders.data_ptr(), _opt(rev_rows, nr),
            gf.data_ptr(), _opt(gr, nr), du.data_ptr(), dcw.data_ptr(),
            dcb.data_ptr(), work.data_ptr(), L, d, b, nb, nr, k,
            _build.stream_of(u))
    _build.check("dir_conv_silu_backward", code)
    _build.launches["dir_conv_silu_backward"] += 1
    return du, dcw.to(cw.dtype), dcb.to(cb.dtype)


class _DirConvSilu(torch.autograd.Function):
    """Forward K2, backward K6 (recomputes the preactivation from u)."""

    @staticmethod
    def forward(ctx, u, cw, cb, orders, rev_rows):
        ctx.save_for_backward(u, cw, cb, orders, rev_rows)
        return _conv_kernel(u, cw, cb, orders, rev_rows)

    @staticmethod
    def backward(ctx, gf, gr):
        u, cw, cb, orders, rev_rows = ctx.saved_tensors
        L, d, b = u.shape
        if gf is None:
            gf = u.new_zeros((orders.shape[0], L, d, b))
        if gr is None:
            gr = u.new_zeros((rev_rows.shape[0], L, d, b))
        du, dcw, dcb = dir_conv_silu_backward(u, cw, cb, orders, rev_rows,
                                              gf, gr)
        return du, dcw, dcb, None, None


def dir_conv_silu(u, cw, cb, orders, rev_rows):
    """Permute + causal/anti-causal conv + SiLU for every stream, on u's
    device: plain version on the CPU, K2 (forward) and K6 (backward) on
    CUDA."""
    if _build.use_plain(u):
        return dir_conv_silu_reference(u, cw, cb, orders, rev_rows)
    orders, rev_rows = _check_conv(u, cw, cb, orders, rev_rows)
    return _DirConvSilu.apply(u, cw, cb, orders, rev_rows)


def _sum_kernel(y_fwd, y_rev, w_fwd, w_rev, inv_orders, rev_rows):
    """K3 for CUDA tensors."""
    nb, L, d, b = y_fwd.shape
    nr = y_rev.shape[0]
    w_fwd = w_fwd.float().contiguous()
    w_rev = w_rev.float().contiguous()
    _build.check_inputs(y_fwd, y_rev, w_fwd, w_rev, inv_orders, rev_rows)
    out = torch.empty((L, d, b), dtype=y_fwd.dtype, device=y_fwd.device)
    with torch.cuda.device(y_fwd.device):
        code = _build.lib().vct_inv_perm_weighted_sum(
            _build.dtype_code(y_fwd), y_fwd.data_ptr(), _opt(y_rev, nr),
            w_fwd.data_ptr(), _opt(w_rev, nr), inv_orders.data_ptr(),
            _opt(rev_rows, nr), out.data_ptr(), L, d, b, nb, nr,
            _build.stream_of(y_fwd))
    _build.check("inv_perm_weighted_sum", code)
    _build.launches["inv_perm_weighted_sum"] += 1
    return out


def inv_perm_weighted_sum_backward(y_fwd, y_rev, w_fwd, w_rev, inv_orders,
                                   rev_rows, g):
    """K7: (dy_fwd, dy_rev, dw_fwd, dw_rev) for CUDA tensors, each in its
    input's dtype; the plain adjoint for CPU tensors."""
    if _build.use_plain(y_fwd):
        return inv_perm_weighted_sum_backward_reference(
            y_fwd, y_rev, w_fwd, w_rev, inv_orders, rev_rows, g)
    inv_orders, rev_rows = _check_sum(y_fwd, y_rev, w_fwd, w_rev, inv_orders,
                                      rev_rows)
    nb, L, d, b = y_fwd.shape
    nr = y_rev.shape[0]
    if g.shape != (L, d, b):
        raise ValueError("cotangent {} is not (L, d, b) = {}".format(
            tuple(g.shape), (L, d, b)))
    g = g.to(y_fwd.dtype).contiguous()
    wf32 = w_fwd.float().contiguous()
    wr32 = w_rev.float().contiguous()
    _build.check_inputs(y_fwd, y_rev, wf32, wr32, inv_orders, rev_rows, g)
    dyf, dyr = torch.empty_like(y_fwd), torch.empty_like(y_rev)
    dw = torch.empty((nb + nr,), dtype=torch.float32, device=y_fwd.device)
    with torch.cuda.device(y_fwd.device):
        work = _build.workspace("vct_inv_perm_weighted_sum_bwd", d, b, nb, nr,
                                device=y_fwd.device)
        code = _build.lib().vct_inv_perm_weighted_sum_bwd(
            _build.dtype_code(y_fwd), g.data_ptr(), y_fwd.data_ptr(),
            _opt(y_rev, nr), wf32.data_ptr(), _opt(wr32, nr),
            inv_orders.data_ptr(), _opt(rev_rows, nr), dyf.data_ptr(),
            _opt(dyr, nr), dw.data_ptr(), work.data_ptr(), L, d, b, nb, nr,
            _build.stream_of(y_fwd))
    _build.check("inv_perm_weighted_sum_backward", code)
    _build.launches["inv_perm_weighted_sum_backward"] += 1
    return dyf, dyr, dw[:nb].to(w_fwd.dtype), dw[nb:].to(w_rev.dtype)


class _InvPermWeightedSum(torch.autograd.Function):
    """Forward K3, backward K7."""

    @staticmethod
    def forward(ctx, y_fwd, y_rev, w_fwd, w_rev, inv_orders, rev_rows):
        ctx.save_for_backward(y_fwd, y_rev, w_fwd, w_rev, inv_orders,
                              rev_rows)
        return _sum_kernel(y_fwd, y_rev, w_fwd, w_rev, inv_orders, rev_rows)

    @staticmethod
    def backward(ctx, g):
        grads = inv_perm_weighted_sum_backward(*ctx.saved_tensors, g)
        return (*grads, None, None)


def inv_perm_weighted_sum(y_fwd, y_rev, w_fwd, w_rev, inv_orders, rev_rows):
    """Inverse permute + per-stream weight + stream sum, on y_fwd's device:
    plain version on the CPU, K3 (forward) and K7 (backward) on CUDA.
    Returns (L, d, b)."""
    if _build.use_plain(y_fwd):
        return inv_perm_weighted_sum_reference(y_fwd, y_rev, w_fwd, w_rev,
                                               inv_orders, rev_rows)
    inv_orders, rev_rows = _check_sum(y_fwd, y_rev, w_fwd, w_rev, inv_orders,
                                      rev_rows)
    return _InvPermWeightedSum.apply(y_fwd, y_rev, w_fwd, w_rev, inv_orders,
                                     rev_rows)
