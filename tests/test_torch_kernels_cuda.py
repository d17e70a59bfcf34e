"""The port's CUDA kernels against their plain PyTorch versions on the card,
at edge shapes the flagship's paths do not reach: sequence lengths that
are no multiple of the staging chunk, odd channel counts, a state size
below 16, no reverse streams, a batch of one, orders that need more than
48 KB of shared memory, attention at its Lk / dh limits, and more groups
than one grid holds. The adjoint kernels (K5-K7) are held against
autograd through the plain forwards, every autograd Function's gradients
against autograd through its plain version, and the summed gradients
must be bitwise equal from one launch to the next. chip_smoke.py covers
the serving and training shapes.

These tests need a CUDA card and skip without one. On the GPU host:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

(``--noconftest``: tests/conftest.py sets up jax for the CPU suite; these
tests need only torch.)

Tolerances: float32 rtol 1e-4 / atol 1e-5 (the kernels sum in another
order than torch); bfloat16 rtol 2e-2 / atol 2e-2 (both sides compute in
float32 and round once to bf16, so they differ by at most one bf16 step).
A gradient summed over batch and time (dA, dD, dcw, dcb, dw) takes its
relative term against the tensor's largest magnitude: both sides add up
to a few hundred thousand float32 terms in different orders, so an entry
that cancels to near zero keeps the absolute error of the large ones.
So does every output of K5: each is a sum (over the state, the channels
or the time steps) whose terms cancel, and K5 takes its exps with the
fast ``__expf`` (~2e-6 relative error) where torch's are exact to an ulp.
"""

import numpy as np
import pytest
import torch

from vit_cnn_tpu_torch.ops import _build
from vit_cnn_tpu_torch.ops.attention import (attention_reference,
                                             fused_attention)
from vit_cnn_tpu_torch.ops.dirstream import (
    dir_conv_silu, dir_conv_silu_backward,
    dir_conv_silu_backward_reference, dir_conv_silu_reference,
    inv_perm_weighted_sum, inv_perm_weighted_sum_backward,
    inv_perm_weighted_sum_backward_reference,
    inv_perm_weighted_sum_reference)
from vit_cnn_tpu_torch.ops.selective_scan import (
    selective_scan, selective_scan_backward,
    selective_scan_backward_reference, selective_scan_reference)

pytestmark = pytest.mark.cuda
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want, dtype):
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), **TOL[dtype])


def _close_summed(got, want, dtype):
    """A gradient that is a sum of cancelling terms: relative to its
    largest magnitude."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if not want.numel():
        return
    tol = TOL[dtype]
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=tol["atol"] + tol["rtol"] * scale)


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lead,L,d,n,b,reverse", [
    ((), 9, 5, 16, 33, False), ((2,), 13, 9, 4, 1, True),
    ((3,), 81, 72, 16, 130, True), ((2,), 1, 8, 16, 7, False)])
def test_selective_scan(gen, dtype, lead, L, d, n, b, reverse):
    u = _randn(gen, *lead, L, d, b).to(dtype)
    dt = torch.nn.functional.softplus(_randn(gen, *lead, L, d, b) - 2).to(
        dtype)
    B, C = (_randn(gen, *lead, L, n, b).to(dtype) for _ in range(2))
    A = -torch.exp(_randn(gen, d, n))
    D = _randn(gen, d)
    before = _build.launches["selective_scan"]
    got = selective_scan(u, dt, A, B, C, D, reverse=reverse)
    assert _build.launches["selective_scan"] == before + 1
    _close(got, selective_scan_reference(u, dt, A, B, C, D, reverse), dtype)


def _orders(L, nb, seed):
    rng = np.random.RandomState(seed)
    orders = np.stack([rng.permutation(L) for _ in range(nb)])
    inv = np.argsort(orders, axis=1)
    i32 = dict(dtype=torch.int32, device="cuda")
    return torch.tensor(orders, **i32), torch.tensor(inv, **i32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L,d,b,nb,rev_rows,k", [
    (9, 5, 37, 3, (0, 2), 4), (81, 72, 64, 6, (0, 1, 2, 3), 4),
    (200, 3, 40, 2, (1,), 2), (16, 8, 1, 2, (), 3)])
def test_dir_conv_silu_and_inverse_sum(gen, dtype, L, d, b, nb, rev_rows, k):
    orders, inv = _orders(L, nb, L)
    rr = torch.tensor(rev_rows, dtype=torch.int32, device="cuda")
    u = _randn(gen, L, d, b).to(dtype)
    cw, cb = 0.5 * _randn(gen, k, d), 0.1 * _randn(gen, d)
    got = dir_conv_silu(u, cw, cb, orders, rr)
    _close(got, dir_conv_silu_reference(u, cw, cb, orders, rr), dtype)
    yf, yr = got
    wf = torch.softmax(_randn(gen, nb), 0)
    wr = torch.softmax(_randn(gen, len(rev_rows) + 1), 0)[:len(rev_rows)]
    _close(inv_perm_weighted_sum(yf, yr, wf, wr, inv, rr),
           inv_perm_weighted_sum_reference(yf, yr, wf, wr, inv, rr), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("G,lq,lk,dh,scale", [
    (3, 5, 64, 256, 0.0625), (70000, 2, 3, 8, 1.0), (17, 49, 9, 128, 1.0),
    (5, 1, 1, 33, 0.5)])
def test_attention(gen, dtype, G, lq, lk, dh, scale):
    q, k, v = (0.5 * _randn(gen, G, n, dh) for n in (lq, lk, lk))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    _close(fused_attention(q, k, v, scale),
           attention_reference(q, k, v, scale), dtype)


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    q = _randn(gen, 2, 3, 8)
    with pytest.raises(ValueError, match="Lk <= 64"):
        fused_attention(q, _randn(gen, 2, 65, 8), _randn(gen, 2, 65, 8), 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        fused_attention(q.transpose(1, 2).contiguous().transpose(1, 2), q, q,
                        1.0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_attention(q.half(), q.half(), q.half(), 1.0)


def _scan_args(gen, lead, L, d, n, b, dtype):
    u = _randn(gen, *lead, L, d, b).to(dtype)
    dt = torch.nn.functional.softplus(_randn(gen, *lead, L, d, b) - 2).to(
        dtype)
    B, C = (_randn(gen, *lead, L, n, b).to(dtype) for _ in range(2))
    A = -torch.exp(0.5 * _randn(gen, d, n))
    D = _randn(gen, d)
    return u, dt, A, B, C, D


SCAN_EDGES = [((), 9, 5, 16, 33, False), ((2,), 13, 9, 4, 1, True),
              ((3,), 81, 72, 16, 130, True), ((2,), 1, 8, 16, 7, False),
              ((4,), 49, 128, 16, 64, False)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lead,L,d,n,b,reverse", SCAN_EDGES)
def test_selective_scan_backward(gen, dtype, lead, L, d, n, b, reverse):
    args = _scan_args(gen, lead, L, d, n, b, dtype)
    g = _randn(gen, *lead, L, d, b).to(dtype)
    before = _build.launches["selective_scan_backward"]
    got = selective_scan_backward(*args, g, reverse=reverse)
    assert _build.launches["selective_scan_backward"] == before + 1
    want = selective_scan_backward_reference(*args, g, reverse)
    for x, y in zip(got, want):
        _close_summed(x, y, dtype)


CONV_EDGES = [(9, 5, 37, 3, (0, 2), 4), (81, 72, 64, 6, (0, 1, 2, 3), 4),
              (200, 3, 40, 2, (1,), 2), (16, 8, 1, 2, (), 3),
              (49, 128, 33, 6, (0, 1, 2, 3), 4)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L,d,b,nb,rev_rows,k", CONV_EDGES)
def test_dirstream_adjoints(gen, dtype, L, d, b, nb, rev_rows, k):
    orders, inv = _orders(L, nb, L + 1)
    rr = torch.tensor(rev_rows, dtype=torch.int32, device="cuda")
    nr = len(rev_rows)
    u = _randn(gen, L, d, b).to(dtype)
    cw, cb = 0.5 * _randn(gen, k, d), 0.1 * _randn(gen, d)
    gf = _randn(gen, nb, L, d, b).to(dtype)
    gr = _randn(gen, nr, L, d, b).to(dtype)
    got = dir_conv_silu_backward(u, cw, cb, orders, rr, gf, gr)
    want = dir_conv_silu_backward_reference(u, cw, cb, orders, rr, gf, gr)
    _close(got[0], want[0], dtype)
    _close_summed(got[1], want[1], dtype)
    _close_summed(got[2], want[2], dtype)

    yf, yr = gf, gr                              # any streams will do
    wf = torch.softmax(_randn(gen, nb), 0)
    wr = torch.softmax(_randn(gen, nr + 1), 0)[:nr]
    g = _randn(gen, L, d, b).to(dtype)
    got = inv_perm_weighted_sum_backward(yf, yr, wf, wr, inv, rr, g)
    want = inv_perm_weighted_sum_backward_reference(yf, yr, wf, wr, inv, rr,
                                                    g)
    _close(got[:2], want[:2], dtype)
    _close_summed(got[2], want[2], dtype)
    _close_summed(got[3], want[3], dtype)


def _grads_through(fn, inputs, g):
    leaves = [x.detach().requires_grad_(x.is_floating_point())
              for x in inputs]
    out = fn(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    gs = g if isinstance(g, tuple) else (g,)
    assert all(o.grad_fn is not None for o in outs)
    torch.autograd.backward(outs, gs)
    return [x.grad for x in leaves if x.is_floating_point()]


def test_every_function_carries_gradients(gen):
    """The gradient of each kernel's autograd Function (forward K1-K4,
    backward K5-K7 or the plain attention formula) against autograd
    through its plain version: the fault where the kernels' outputs had no
    grad_fn and every parameter upstream got no gradient."""
    dtype = torch.float32
    args = _scan_args(gen, (2,), 13, 9, 16, 40, dtype)
    g = _randn(gen, 2, 13, 9, 40)
    for rev in (False, True):
        got = _grads_through(
            lambda *a: selective_scan(*a, reverse=rev), args, g)
        want = _grads_through(
            lambda *a: selective_scan_reference(*a, reverse=rev), args, g)
        for x, y in zip(got, want):
            _close_summed(x, y, dtype)

    orders, inv = _orders(11, 3, 5)
    rr = torch.tensor((0, 2), dtype=torch.int32, device="cuda")
    u = _randn(gen, 11, 6, 35)
    cw, cb = 0.5 * _randn(gen, 4, 6), 0.1 * _randn(gen, 6)
    gs = (_randn(gen, 3, 11, 6, 35), _randn(gen, 2, 11, 6, 35))
    conv = lambda *a: dir_conv_silu(*a, orders, rr)
    conv_ref = lambda *a: dir_conv_silu_reference(*a, orders, rr)
    for x, y in zip(_grads_through(conv, (u, cw, cb), gs),
                    _grads_through(conv_ref, (u, cw, cb), gs)):
        _close_summed(x, y, dtype)

    yf, yr = gs
    w = (torch.softmax(_randn(gen, 3), 0), torch.softmax(_randn(gen, 2), 0))
    g = _randn(gen, 11, 6, 35)
    isum = lambda *a: inv_perm_weighted_sum(*a, inv, rr)
    isum_ref = lambda *a: inv_perm_weighted_sum_reference(*a, inv, rr)
    for x, y in zip(_grads_through(isum, (yf, yr) + w, g),
                    _grads_through(isum_ref, (yf, yr) + w, g)):
        _close_summed(x, y, dtype)

    q, k, v = (0.5 * _randn(gen, 33, n, 24) for n in (7, 3, 3))
    g = _randn(gen, 33, 7, 24)
    att = lambda *a: fused_attention(*a, 0.7)
    att_ref = lambda *a: attention_reference(*a, 0.7)
    for x, y in zip(_grads_through(att, (q, k, v), g),
                    _grads_through(att_ref, (q, k, v), g)):
        _close(x, y, dtype)


def test_summed_gradients_are_bitwise_repeatable(gen):
    """dA, dD, dcw, dcb and dw come from per-block partials added in a
    fixed order (no atomics): two launches give the same bits."""
    dtype = torch.bfloat16
    args = _scan_args(gen, (6,), 81, 72, 16, 1001, dtype)
    g = _randn(gen, 6, 81, 72, 1001).to(dtype)
    first = selective_scan_backward(*args, g)
    second = selective_scan_backward(*args, g)
    for i in (2, 5):
        assert torch.equal(first[i], second[i])

    orders, inv = _orders(81, 6, 3)
    rr = torch.tensor((0, 1, 2, 3), dtype=torch.int32, device="cuda")
    u = _randn(gen, 81, 72, 1001).to(dtype)
    cw, cb = 0.5 * _randn(gen, 4, 72), 0.1 * _randn(gen, 72)
    gf = _randn(gen, 6, 81, 72, 1001).to(dtype)
    gr = _randn(gen, 4, 81, 72, 1001).to(dtype)
    first = dir_conv_silu_backward(u, cw, cb, orders, rr, gf, gr)
    second = dir_conv_silu_backward(u, cw, cb, orders, rr, gf, gr)
    assert torch.equal(first[1], second[1]) and torch.equal(first[2],
                                                            second[2])
    wf, wr = torch.softmax(_randn(gen, 6), 0), torch.softmax(_randn(gen, 4), 0)
    first = inv_perm_weighted_sum_backward(gf, gr, wf, wr, inv, rr, u)
    second = inv_perm_weighted_sum_backward(gf, gr, wf, wr, inv, rr, u)
    assert torch.equal(first[2], second[2]) and torch.equal(first[3],
                                                            second[3])
