"""The port's directional-stream ops (plain versions, the CPU path of
vit_cnn_tpu_torch.ops.dirstream) against the JAX package's reference
formulations, with the real token orders of the flagship's path types.

Tolerance: the JAX suite's float32 op tolerance, rtol 2e-4 / atol 2e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_cnn_tpu.ops.dirstream import (dir_conv_silu_reference as jax_conv,
                                       inv_perm_weighted_sum_reference
                                       as jax_inv_sum)
from vit_cnn_tpu_torch.ops import _build
from vit_cnn_tpu_torch.ops.dirstream import (dir_conv_silu,
                                             inv_perm_weighted_sum)
from vit_cnn_tpu_torch.ops.scan_paths import base_paths, inverse_permutation

RTOL, ATOL = 2e-4, 2e-5
D, B, K = 8, 5, 4


def _tables(path, L):
    orders, bases, _, rev_dir = base_paths(path, L)
    orders_t = tuple(tuple(int(v) for v in orders[i]) for i in bases)
    inv_t = tuple(tuple(int(v) for v in inverse_permutation(orders[i]))
                  for i in bases)
    rev_rows = tuple(i for i, r in enumerate(rev_dir) if r >= 0)
    return orders_t, inv_t, rev_rows


def _i32(x):
    return torch.tensor(x, dtype=torch.int32)


CASES = [("81_2+8", 81), ("49_2+8", 49), ("81twoclock", 81)]


@pytest.mark.parametrize("path,L", CASES)
def test_dir_conv_silu_matches_jax_reference(path, L):
    orders, _, rev_rows = _tables(path, L)
    rng = np.random.RandomState(0)
    u = rng.randn(L, D, B).astype(np.float32)
    cw = (0.5 * rng.randn(K, D)).astype(np.float32)
    cb = (0.1 * rng.randn(D)).astype(np.float32)
    want_f, want_r = jax_conv(jnp.asarray(u), jnp.asarray(cw),
                              jnp.asarray(cb), orders, rev_rows)
    got_f, got_r = dir_conv_silu(torch.from_numpy(u), torch.from_numpy(cw),
                                 torch.from_numpy(cb), _i32(orders),
                                 _i32(rev_rows))
    assert got_f.shape == (len(orders), L, D, B)
    assert got_r.shape == (len(rev_rows), L, D, B)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("path,L", CASES)
def test_inv_perm_weighted_sum_matches_jax_reference(path, L):
    orders, inv, rev_rows = _tables(path, L)
    rng = np.random.RandomState(1)
    nb, nr = len(orders), len(rev_rows)
    yf = rng.randn(nb, L, D, B).astype(np.float32)
    yr = rng.randn(nr, L, D, B).astype(np.float32)
    w = np.exp(rng.randn(10)).astype(np.float32)
    w = w / w.sum()
    wf, wr = w[:nb], w[nb:nb + nr]
    want = jax_inv_sum(jnp.asarray(yf), jnp.asarray(yr), inv, rev_rows,
                       jnp.asarray(wf), jnp.asarray(wr))
    before = _build.launches["inv_perm_weighted_sum"]
    got = inv_perm_weighted_sum(torch.from_numpy(yf), torch.from_numpy(yr),
                                torch.from_numpy(wf), torch.from_numpy(wr),
                                _i32(inv), _i32(rev_rows))
    assert _build.launches["inv_perm_weighted_sum"] == before
    assert got.shape == (L, D, B)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_round_trip_restores_token_order():
    """Streams gathered by the base orders (and their reverse twins) come
    back in token order: with unit weights the sum over the '49_2+8'
    streams is (nb + nr) times the signal."""
    orders, inv, rev_rows = _tables("49_2+8", 49)
    x = torch.randn(49, D, B, generator=torch.Generator().manual_seed(2))
    yf = x[_i32(orders).long()]
    yr = yf[_i32(rev_rows).long()]
    nb, nr = len(orders), len(rev_rows)
    got = inv_perm_weighted_sum(yf, yr, torch.ones(nb), torch.ones(nr),
                                _i32(inv), _i32(rev_rows))
    torch.testing.assert_close(got, (nb + nr) * x, rtol=1e-6, atol=1e-5)
