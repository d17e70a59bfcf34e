"""The port's plain adjoints — what the kernels K5, K6 and K7 are held to on
the card — against the JAX package: its Pallas adjoint kernels
(``_pallas_backward`` with lane-major 4-D IO, ``_dir_conv_adjoint``,
``_inv_sum_adjoint``) run in interpret mode, and ``jax.vjp`` of its
reference formulations; and the attention backward against
``jax.vjp(attention_reference)``. Seeded numpy inputs go to both sides.

Tolerances: against ``jax.vjp`` of the references, the JAX suite's float32
op tolerance, rtol 2e-4 / atol 2e-5 (the port's sequential scan against
the associative one, torch's sums against XLA's). Against the scan's
Pallas adjoint, rtol 2e-3 / atol 2e-4: the tolerance
tests/test_scan_backward.py holds that kernel to autodiff with (its
chunked recompute adds in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vit_cnn_tpu.ops.attention import attention_reference as jax_attention
from vit_cnn_tpu.ops.dirstream import (_dir_conv_adjoint, _inv_sum_adjoint,
                                       dir_conv_silu_reference as jax_conv,
                                       inv_perm_weighted_sum_reference
                                       as jax_inv_sum)
from vit_cnn_tpu.ops.selective_scan import (_pallas_backward,
                                            selective_scan as jax_scan)
from vit_cnn_tpu_torch.ops import _build, attention
from vit_cnn_tpu_torch.ops.dirstream import (dir_conv_silu_backward,
                                             inv_perm_weighted_sum_backward)
from vit_cnn_tpu_torch.ops.scan_paths import base_paths, inverse_permutation
from vit_cnn_tpu_torch.ops.selective_scan import (
    selective_scan, selective_scan_backward)

RTOL, ATOL = 2e-4, 2e-5
PALLAS_RTOL, PALLAS_ATOL = 2e-3, 2e-4
NS, L, D, N, B = 2, 13, 8, 4, 5     # 13 tokens: 4 time chunks, a ragged one


def _scan_inputs(seed):
    rng = np.random.RandomState(seed)
    u = rng.randn(NS, L, D, B).astype(np.float32)
    dt = (np.abs(rng.randn(NS, L, D, B)) * 0.1 + 0.01).astype(np.float32)
    A = -np.exp(0.5 * rng.randn(D, N)).astype(np.float32)
    Bm = rng.randn(NS, L, N, B).astype(np.float32)
    Cm = rng.randn(NS, L, N, B).astype(np.float32)
    Dv = rng.randn(D).astype(np.float32)
    g = rng.randn(NS, L, D, B).astype(np.float32)
    return (u, dt, A, Bm, Cm, Dv), g


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want, rtol=RTOL, atol=ATOL):
    for gv, wv in zip(got, want):
        np.testing.assert_allclose(np.asarray(gv), np.asarray(wv),
                                   rtol=rtol, atol=atol)


def _batch_major(x):
    ns, l, ch, b = x.shape
    return np.moveaxis(x, 3, 1).reshape(ns * b, l, ch)


def _lane_major(y, ch):
    return np.moveaxis(np.asarray(y).reshape(NS, B, L, ch), 1, 3)


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_adjoint_matches_pallas_interpret(reverse):
    """The Pallas adjoint kernel itself, lane-major 4-D IO, a batch block
    of 2 that forces its ragged-edge padding."""
    args, g = _scan_inputs(0)
    with pltpu.force_tpu_interpret_mode():
        want = _pallas_backward(*(jnp.asarray(a) for a in args),
                                jnp.asarray(g), block_b=2, reverse=reverse,
                                lane_major_io=True)
    before = _build.launches["selective_scan_backward"]
    got = selective_scan_backward(*_torch(args), torch.from_numpy(g),
                                  reverse=reverse)
    assert _build.launches["selective_scan_backward"] == before
    assert [tuple(x.shape) for x in got] == [a.shape for a in args]
    _close([x.numpy() for x in got], want, PALLAS_RTOL, PALLAS_ATOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_autograd_matches_jax_vjp(reverse):
    """Autograd through the port's scan (the CPU path of the autograd
    Function's backward) against jax.vjp of the associative scan."""
    args, g = _scan_inputs(1)
    u, dt, A, Bm, Cm, Dv = args
    bm = [jnp.asarray(_batch_major(x)) for x in (u, dt)]
    _, vjp = jax.vjp(lambda *a: jax_scan(*a, reverse=reverse), bm[0], bm[1],
                     jnp.asarray(A), jnp.asarray(_batch_major(Bm)),
                     jnp.asarray(_batch_major(Cm)), jnp.asarray(Dv))
    du, ddt, dA, dB, dC, dD = vjp(jnp.asarray(_batch_major(g)))
    want = [_lane_major(du, D), _lane_major(ddt, D), dA, _lane_major(dB, N),
            _lane_major(dC, N), dD]
    leaves = [t.requires_grad_() for t in _torch(args)]
    selective_scan(*leaves, reverse=reverse).backward(torch.from_numpy(g))
    _close([t.grad.numpy() for t in leaves], want)


def _tables(path, length):
    orders, bases, _, rev_dir = base_paths(path, length)
    orders_t = tuple(tuple(int(v) for v in orders[i]) for i in bases)
    inv_t = tuple(tuple(int(v) for v in inverse_permutation(orders[i]))
                  for i in bases)
    rev_rows = tuple(i for i, r in enumerate(rev_dir) if r >= 0)
    return orders_t, inv_t, rev_rows


def _i32(x):
    return torch.tensor(x, dtype=torch.int32)


CASES = [("49_2+8", 49, 5), ("9_2+8", 9, 3)]


def _dir_conv_adjoint_case(orders, rev_rows, length, b, k):
    rng = np.random.RandomState(2)
    u = rng.randn(length, D, b).astype(np.float32)
    cw = (0.5 * rng.randn(k, D)).astype(np.float32)
    cb = (0.1 * rng.randn(D)).astype(np.float32)
    gf = rng.randn(len(orders), length, D, b).astype(np.float32)
    gr = rng.randn(len(rev_rows), length, D, b).astype(np.float32)
    got = [x.numpy() for x in dir_conv_silu_backward(
        *_torch((u, cw, cb)), _i32(orders), _i32(rev_rows),
        *_torch((gf, gr)))]
    with pltpu.force_tpu_interpret_mode():
        pallas = _dir_conv_adjoint(*(jnp.asarray(a) for a in (u, cw, cb, gf,
                                                              gr)),
                                   orders, rev_rows, block_b=2)
    _, vjp = jax.vjp(lambda *a: jax_conv(*a, orders, rev_rows),
                     *(jnp.asarray(a) for a in (u, cw, cb)))
    _close(got, pallas)
    _close(got, vjp((jnp.asarray(gf), jnp.asarray(gr))))


@pytest.mark.parametrize("path,length,b", CASES)
def test_dir_conv_adjoint_matches_jax(path, length, b):
    orders, _, rev_rows = _tables(path, length)
    _dir_conv_adjoint_case(orders, rev_rows, length, b, 4)


@pytest.mark.parametrize("path,length,b,k,rev_rows", [
    ("49_2+8", 49, 5, 2, None), ("9_2+8", 9, 3, 2, (2, 0)),
    ("9_2+8", 9, 3, 4, (3, 1, 0)), ("49_2+8", 49, 5, 4, ())])
def test_dir_conv_adjoint_at_other_taps_and_reverse_rows(path, length, b, k,
                                                        rev_rows):
    """The plain K6 adjoint against the Pallas adjoint at k = 2 and with
    the reverse streams listed out of order or absent: a reverse stream's
    slot comes from rev_rows, not from its order's position."""
    orders, _, table_rows = _tables(path, length)
    _dir_conv_adjoint_case(orders, table_rows if rev_rows is None
                           else rev_rows, length, b, k)


@pytest.mark.parametrize("path,length,b", CASES)
def test_inv_sum_adjoint_matches_jax(path, length, b):
    orders, inv, rev_rows = _tables(path, length)
    nb, nr = len(orders), len(rev_rows)
    rng = np.random.RandomState(3)
    yf = rng.randn(nb, length, D, b).astype(np.float32)
    yr = rng.randn(nr, length, D, b).astype(np.float32)
    w = rng.randn(nb + nr).astype(np.float32)
    wf, wr = w[:nb], w[nb:]
    g = rng.randn(length, D, b).astype(np.float32)
    got = [x.numpy() for x in inv_perm_weighted_sum_backward(
        *_torch((yf, yr, wf, wr)), _i32(inv), _i32(rev_rows),
        torch.from_numpy(g))]
    with pltpu.force_tpu_interpret_mode():
        pallas = _inv_sum_adjoint(*(jnp.asarray(a) for a in (yf, yr, wf, wr,
                                                             g)),
                                  inv, rev_rows, block_b=2)
    _, vjp = jax.vjp(lambda yf, yr, wf, wr: jax_inv_sum(yf, yr, inv,
                                                        rev_rows, wf, wr),
                     *(jnp.asarray(a) for a in (yf, yr, wf, wr)))
    _close(got, pallas)
    _close(got, vjp(jnp.asarray(g)))


def test_attention_gradients_match_jax_vjp():
    rng = np.random.RandomState(4)
    q = (0.5 * rng.randn(6, 7, 16)).astype(np.float32)
    k = (0.5 * rng.randn(6, 3, 16)).astype(np.float32)
    v = rng.randn(6, 3, 16).astype(np.float32)
    g = rng.randn(6, 7, 16).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jax_attention(*a, 0.7),
                     *(jnp.asarray(a) for a in (q, k, v)))
    leaves = [t.requires_grad_() for t in _torch((q, k, v))]
    attention.fused_attention(*leaves, 0.7).backward(torch.from_numpy(g))
    _close([t.grad.numpy() for t in leaves], vjp(jnp.asarray(g)))


def test_bf16_gradients_come_back_in_the_inputs_dtypes():
    """As the JAX wrappers return them: each gradient in its input's
    dtype, computed in float32 and rounded once."""
    args, g = _scan_inputs(5)
    lo = [torch.from_numpy(a).to(torch.bfloat16) for a in args]
    got = selective_scan_backward(lo[0], lo[1], torch.from_numpy(args[2]),
                                  lo[3], lo[4], torch.from_numpy(args[5]),
                                  torch.from_numpy(g).to(torch.bfloat16))
    assert [x.dtype for x in got] == [torch.bfloat16] * 2 + [
        torch.float32] + [torch.bfloat16] * 2 + [torch.float32]
    want = selective_scan_backward(
        *(x.float() for x in lo[:2]), torch.from_numpy(args[2]),
        *(x.float() for x in lo[3:5]), torch.from_numpy(args[5]),
        torch.from_numpy(g).to(torch.bfloat16).float())
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y.to(x.dtype), rtol=0, atol=0)
