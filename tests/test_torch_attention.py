"""The port's small-sequence attention (plain version, the CPU path of
vit_cnn_tpu_torch.ops.attention) against the JAX package's
``attention_reference`` and its Pallas ``fused_attention`` in interpret
mode, at the NonLocal block's shapes: 49 queries x 9 keys at 128
channels and 25 x 4 at 72, unscaled (scale 1.0).

Tolerance: the JAX suite's float32 op tolerance, rtol 2e-4 / atol 2e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_cnn_tpu.ops.attention import (attention_reference as jax_ref,
                                       fused_attention as jax_fused,
                                       fused_attention_auto as jax_auto)
from vit_cnn_tpu_torch.ops.attention import (fused_attention,
                                             fused_attention_auto)

RTOL, ATOL = 2e-4, 2e-5
SHAPES = [(49, 9, 128), (25, 4, 72)]


def _qkv(lead, lq, lk, dh, seed):
    rng = np.random.RandomState(seed)
    q = (0.3 * rng.randn(*lead, lq, dh)).astype(np.float32)
    k = (0.3 * rng.randn(*lead, lk, dh)).astype(np.float32)
    v = rng.randn(*lead, lk, dh).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("lq,lk,dh", SHAPES)
def test_rank3_matches_jax_reference(lq, lk, dh):
    q, k, v = _qkv((5,), lq, lk, dh, 0)
    want = jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 1.0)
    got = fused_attention(*(torch.from_numpy(x) for x in (q, k, v)), 1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("lq,lk,dh", SHAPES)
def test_rank3_matches_pallas_kernel_interpret(lq, lk, dh):
    """The Pallas TPU kernel itself, with a group block of 2 that forces
    its ragged-edge padding (G = 5)."""
    from jax.experimental.pallas import tpu as pltpu

    q, k, v = _qkv((5,), lq, lk, dh, 1)
    with pltpu.force_tpu_interpret_mode():
        want = jax_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         1.0, 2)
    got = fused_attention(*(torch.from_numpy(x) for x in (q, k, v)), 1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("lq,lk,dh", SHAPES)
def test_rank4_folds_like_jax(lq, lk, dh):
    q, k, v = _qkv((2, 3), lq, lk, dh, 2)
    want = jax_auto(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 1.0)
    got = fused_attention_auto(*(torch.from_numpy(x) for x in (q, k, v)),
                               1.0)
    assert got.shape == (2, 3, lq, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_scale_is_applied():
    q, k, v = _qkv((3,), 49, 9, 16, 3)
    want = jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.25)
    got = fused_attention(*(torch.from_numpy(x) for x in (q, k, v)), 0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
