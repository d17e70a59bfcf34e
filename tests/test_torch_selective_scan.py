"""The port's selective scan (plain version, the CPU path of
vit_cnn_tpu_torch.ops.selective_scan) against the JAX package's
associative-scan ``selective_scan`` and its Pallas kernel in interpret
mode, on the same numpy inputs.

Tolerance: the JAX suite's float32 op tolerance, rtol 2e-4 / atol 2e-5
(sequential against associative summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_cnn_tpu.ops.selective_scan import (selective_scan as jax_scan,
                                            selective_scan_pallas)
from vit_cnn_tpu_torch.ops import _build
from vit_cnn_tpu_torch.ops.selective_scan import (selective_scan,
                                                  selective_scan_reference)

RTOL, ATOL = 2e-4, 2e-5
NS, L, D, N, B = 3, 81, 8, 16, 5      # ragged batch: 5 is no block multiple


def _inputs(seed):
    """Lane-major (ns, L, d, b) / (ns, L, n, b) inputs."""
    rng = np.random.RandomState(seed)
    u = rng.randn(NS, L, D, B).astype(np.float32)
    dt = (np.abs(rng.randn(NS, L, D, B)) * 0.1 + 0.01).astype(np.float32)
    A = -np.exp(np.log(np.arange(1, N + 1))[None]
                + 0.1 * rng.randn(D, N)).astype(np.float32)
    Bm = rng.randn(NS, L, N, B).astype(np.float32)
    Cm = rng.randn(NS, L, N, B).astype(np.float32)
    Dv = rng.randn(D).astype(np.float32)
    return u, dt, A, Bm, Cm, Dv


def _batch_major(x):
    """(ns, L, ch, b) -> (ns*b, L, ch), the JAX function's layout."""
    ns, l, ch, b = x.shape
    return np.moveaxis(x, 3, 1).reshape(ns * b, l, ch)


def _lane_major(y):
    return np.moveaxis(y.reshape(NS, B, L, -1), 1, 3)


def _port(args, reverse, rank):
    u, dt, A, Bm, Cm, Dv = (torch.from_numpy(a) for a in args)
    if rank == 3:                       # one stream, (L, d, b)
        y = torch.stack([selective_scan(u[s], dt[s], A, Bm[s], Cm[s], Dv,
                                        reverse=reverse) for s in range(NS)])
    else:
        y = selective_scan(u, dt, A, Bm, Cm, Dv, reverse=reverse)
    return y.numpy()


@pytest.mark.parametrize("rank", [3, 4])
@pytest.mark.parametrize("reverse", [False, True])
def test_matches_jax_associative_scan(rank, reverse):
    args = _inputs(0)
    u, dt, A, Bm, Cm, Dv = args
    want = jax_scan(*(jnp.asarray(x) for x in (
        _batch_major(u), _batch_major(dt), A, _batch_major(Bm),
        _batch_major(Cm), Dv)), reverse=reverse)
    got = _port(args, reverse, rank)
    np.testing.assert_allclose(got, _lane_major(np.asarray(want)),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("rank", [3, 4])
@pytest.mark.parametrize("reverse", [False, True])
def test_matches_pallas_kernel_interpret(rank, reverse):
    """The Pallas TPU kernel itself, in its lane-major IO, with a batch
    block of 2 that forces its ragged-edge padding."""
    from jax.experimental.pallas import tpu as pltpu

    args = _inputs(1)
    u, dt, A, Bm, Cm, Dv = args
    with pltpu.force_tpu_interpret_mode():
        if rank == 3:
            want = np.stack([np.asarray(selective_scan_pallas(
                jnp.asarray(u[s]), jnp.asarray(dt[s]), jnp.asarray(A),
                jnp.asarray(Bm[s]), jnp.asarray(Cm[s]), jnp.asarray(Dv),
                2, reverse, True)) for s in range(NS)])
        else:
            want = np.asarray(selective_scan_pallas(
                *(jnp.asarray(x) for x in args), 2, reverse, True))
    np.testing.assert_allclose(_port(args, reverse, rank), want,
                               rtol=RTOL, atol=ATOL)


def test_bf16_inputs_keep_a_float32_state():
    """bf16 streams in, bf16 out, float32 state: equal to the float32 scan
    of the same (bf16-rounded) values, rounded once at the end."""
    u, dt, A, Bm, Cm, Dv = (torch.from_numpy(a) for a in _inputs(2))
    lo = [x.to(torch.bfloat16) for x in (u, dt, Bm, Cm)]
    got = selective_scan(lo[0], lo[1], A, lo[2], lo[3], Dv)
    want = selective_scan_reference(*(x.float() for x in lo[:2]), A,
                                    *(x.float() for x in lo[2:]), Dv)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want.to(torch.bfloat16), rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    args = [torch.from_numpy(a) for a in _inputs(3)]
    before = _build.launches["selective_scan"]
    torch.testing.assert_close(selective_scan(*args),
                               selective_scan_reference(*args),
                               rtol=0, atol=0)
    assert _build.launches["selective_scan"] == before


def test_other_devices_raise():
    args = [torch.from_numpy(a).to("meta") for a in _inputs(4)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        selective_scan(*args)
