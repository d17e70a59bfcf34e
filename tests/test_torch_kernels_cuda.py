"""The port's CUDA kernels against their plain PyTorch versions on the card,
at edge shapes the serving path does not reach: sequence lengths that are
no multiple of the staging chunk, odd channel counts, a state size below
16, no reverse streams, orders that need more than 48 KB of shared
memory, attention at its Lk / dh limits, and more groups than one grid
holds. chip_smoke.py covers the serving shapes.

These tests need a CUDA card and skip without one. On the GPU host:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

(``--noconftest``: tests/conftest.py imports jax, which that host lacks.)

Tolerances: float32 rtol 1e-4 / atol 1e-5 (the kernels sum in another
order than torch); bfloat16 rtol 2e-2 / atol 2e-2 (both sides compute in
float32 and round once to bf16, so they differ by at most one bf16 step).
"""

import numpy as np
import pytest
import torch

from vit_cnn_tpu_torch.ops import _build
from vit_cnn_tpu_torch.ops.attention import (attention_reference,
                                             fused_attention)
from vit_cnn_tpu_torch.ops.dirstream import (dir_conv_silu,
                                             dir_conv_silu_reference,
                                             inv_perm_weighted_sum,
                                             inv_perm_weighted_sum_reference)
from vit_cnn_tpu_torch.ops.selective_scan import (selective_scan,
                                                  selective_scan_reference)

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
