"""One flagship train step of the port against the JAX package's, on the
CPU: the same seeded flax variables (through vit_cnn_tpu_torch.convert),
the same numpy batch (a padded last row with valid 0, an ignored class of
weight 0), train-mode BatchNorm on both sides. The JAX side is
``jax.value_and_grad`` of the weighted cross-entropy of
``module.apply(train=True, mutable=["batch_stats"])``; its gradient tree
and updated batch stats map onto the port's keys through
``convert.flax_to_state_dict``.

The step runs twice on each side: in float64 (JAX under ``enable_x64``,
the port's plain path in float64), where the two must agree to rounding,
and in float32, as the programs run.

Tolerances.
* float64: loss, statistics and every gradient within 1e-7 (relative, per
  tensor in norm, plus 1e-12 of the largest gradient norm for gradients
  that vanish mathematically): float64 rounding amplified by the
  network's conditioning, with margin.
* float32 loss and updated statistics: rtol 2e-4 / atol 2e-5, the JAX
  suite's float32 op tolerance.
* float32 gradients, against the float64 step: ||port - jax64|| <= 5e-2
  ||jax64|| + 1e-5 max_k ||jax64_k||. The flagship's gradients are
  ill-conditioned (train-mode BatchNorm over a batch of 4, ReLU and max
  kinks): JAX's own float32 step is off its float64 step by up to 1.9e-2
  on some tensors here, the port's by up to 1.7e-2 (measured when this
  test was written). The floor covers gradients that vanish
  mathematically (biases ahead of a train-mode BatchNorm), float32 noise
  of ~1e-9 of the largest.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_cnn_tpu.models.mm_mamba import MultimodalityMamba as JaxFlagship
from vit_cnn_tpu.train.losses import weighted_cross_entropy as jax_ce
from vit_cnn_tpu_torch.convert import flax_to_state_dict, seeded_variables
from vit_cnn_tpu_torch.models.mm_mamba import MultimodalityMamba
from vit_cnn_tpu_torch.train.losses import weighted_cross_entropy

RTOL, ATOL = 2e-4, 2e-5
TOL64, FLOOR64 = 1e-7, 1e-12
GRAD_RTOL, GRAD_FLOOR = 5e-2, 1e-5
P, BANDS, LIDAR, K, BATCH = 9, 20, 1, 6, 4


def _port_model(tree):
    tm = MultimodalityMamba(P, BANDS, LIDAR, 32, K)
    tm.load_state_dict(flax_to_state_dict(tree, tm))
    return tm


@pytest.fixture(scope="module")
def steps():
    jm = JaxFlagship(img_size=P, in_channels1=BANDS, in_channels2=LIDAR,
                     dim_embedding=32, n_classes=K)
    key = jax.random.PRNGKey(0)
    init = flax.core.unfreeze(jax.eval_shape(lambda: jm.init(
        {"params": key, "dropout": key}, jnp.zeros((2, P, P, BANDS)),
        jnp.zeros((2, P, P, LIDAR)), train=False)))
    tree = seeded_variables(init, seed=0)
    rng = np.random.RandomState(1)
    hsi = rng.rand(BATCH, P, P, BANDS).astype(np.float32)
    lidar = rng.rand(BATCH, P, P, LIDAR).astype(np.float32)
    labels = np.array([1, 3, 0, 5])
    weights = np.array([0, 1, 1, 0.5, 1, 2], np.float32)
    valid = np.array([1, 1, 1, 0], np.float32)       # a padded last row

    def jax_step(dtype):
        cast = lambda t: jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, dtype), t)
        variables = cast(tree)

        def loss_fn(params):
            out, upd = jm.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                jnp.asarray(hsi, dtype), jnp.asarray(lidar, dtype),
                train=True, mutable=["batch_stats"], rngs={"dropout": key})
            return jax_ce(out, jnp.asarray(labels),
                          jnp.asarray(weights, dtype),
                          jnp.asarray(valid, dtype)), upd

        (loss, upd), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(variables["params"])
        as64 = lambda t: jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), jax.device_get(t))
        want = flax_to_state_dict(
            {"params": as64(grads), "batch_stats": as64(upd["batch_stats"])},
            MultimodalityMamba(P, BANDS, LIDAR, 32, K).double())
        return float(loss), want

    def port_step(dtype):
        tm = _port_model(tree).to(dtype).train()
        out = tm(torch.from_numpy(hsi).to(dtype),
                 torch.from_numpy(lidar).to(dtype))
        loss = weighted_cross_entropy(out, torch.from_numpy(labels),
                                      torch.from_numpy(weights).to(dtype),
                                      torch.from_numpy(valid).to(dtype))
        loss.backward()
        return float(loss.detach()), tm

    with jax.enable_x64(True):
        jax64 = jax_step(jnp.float64)
    return {"jax64": jax64, "jax32": jax_step(jnp.float32),
            "port64": port_step(torch.float64),
            "port32": port_step(torch.float32)}


def _stats(tm):
    return {k: v for k, v in tm.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _check_grads(tm, want, rtol, floor_share):
    params = dict(tm.named_parameters())
    floor = floor_share * max(float(want[k].norm()) for k in params)
    for k, p in params.items():
        assert p.grad is not None, k
        err = float((p.grad.double() - want[k]).norm())
        assert err <= rtol * float(want[k].norm()) + floor, (
            k, err, float(want[k].norm()))


def test_float64_step_matches_jax(steps):
    loss, want = steps["jax64"]
    got, tm = steps["port64"]
    assert got == pytest.approx(loss, rel=TOL64)
    stats = _stats(tm)
    assert len(stats) == 32
    for k, v in stats.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=TOL64,
                                   atol=0, err_msg=k)
    _check_grads(tm, want, TOL64, FLOOR64)


def test_float32_loss_and_statistics_match_jax(steps):
    loss, want = steps["jax32"]
    got, tm = steps["port32"]
    assert got == pytest.approx(loss, rel=RTOL, abs=ATOL)
    for k, v in _stats(tm).items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_float32_gradients_are_as_close_as_jax_float32(steps):
    """Every parameter of the float32 step gets a gradient, within the
    conditioning-bound tolerance of the float64 step's; JAX's own float32
    step meets the same bound."""
    _, want = steps["jax64"]
    _, tm = steps["port32"]
    _check_grads(tm, want, GRAD_RTOL, GRAD_FLOOR)
    _, jax32 = steps["jax32"]
    floor = GRAD_FLOOR * max(float(want[k].norm()) for k in jax32
                             if not k.endswith(("_mean", "_var")))
    for k, g in jax32.items():
        if not k.endswith(("running_mean", "running_var")):
            assert float((g - want[k]).norm()) <= GRAD_RTOL * float(
                want[k].norm()) + floor, k
