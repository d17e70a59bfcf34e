"""MoCo pretraining in the port against the JAX package, on the CPU.

* ``TwoViewPipeline``: every interior pixel a center, view 1 the raw
  gather, and both views equal the JAX ``make_views`` on its own draws
  (rebuilt by its key splits, tests/test_torch_augment.py) within
  rtol 1e-5 / atol 1e-6; the center labels exactly.
* The encoder's flax variables and a whole ``MoCoState`` converted both
  ways bit for bit.
* ``moco_forward`` in float32 against JAX's from the same converted
  variables, key variables and queue (the pointer one batch from the
  end, so it wraps): logits, k, the new queue and key variables within
  the JAX suite's float32 tolerance, rtol 2e-4 / atol 2e-5; target and
  pointer exactly.
* One pretraining step in float64 (the masked mean InfoNCE loss with a
  padded row, its gradients and the Adam update) against
  ``jax.value_and_grad`` and ``optax.adam`` under ``enable_x64``: within
  1e-7 (per tensor in norm).
* No running BatchNorm statistic changes over an epoch; the learning
  rate schedule equals JAX's; a best-epoch file the port writes is read
  by the JAX package's ``restore_checkpoint`` into its encoder's
  variables; ``--pretrain`` through the CLI on the CPU.
"""

import io
import json
import os
from contextlib import redirect_stdout

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_augment import _jax_draws

from vit_cnn_tpu.models import moco as jax_moco
from vit_cnn_tpu.pipeline.patches import AugmentConfig as JaxAugment
from vit_cnn_tpu.pipeline.twoview import TwoViewPipeline as JaxTwoView
from vit_cnn_tpu.train import checkpoint as jax_ckpt
from vit_cnn_tpu.train import pretrain as jax_pretrain
from vit_cnn_tpu_torch import cli
from vit_cnn_tpu_torch.convert import (flax_to_moco_state, flax_to_state_dict,
                                       moco_state_to_flax, seeded_variables,
                                       state_dict_to_flax)
from vit_cnn_tpu_torch.models.moco import DualModalEncoder, moco_forward
from vit_cnn_tpu_torch.nn.layers import init_parameters
from vit_cnn_tpu_torch.pipeline.patches import AugmentConfig
from vit_cnn_tpu_torch.pipeline.twoview import TwoViewPipeline
from vit_cnn_tpu_torch.train.pretrain import Pretrainer, adjust_learning_rate

RTOL, ATOL = 2e-4, 2e-5
TOL64 = 1e-7
P, C1, C2, D = 5, 6, 1, 16
B, QUEUE = 8, 32


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _scene(seed=0, h=14, w=16, classes=5):
    rng = np.random.RandomState(seed)
    img1 = rng.rand(h, w, C1).astype(np.float32)
    img2 = rng.rand(h, w, C2).astype(np.float32)
    gt = rng.randint(0, classes, (h, w)).astype(np.int64)
    return img1, img2, gt


@pytest.fixture(scope="module")
def case():
    """The JAX encoder, seeded online and key variables, JAX's queue with
    its pointer one batch from the end, and views from a numpy seed."""
    enc = jax_moco.DualModalEncoder(embed_dim=D)
    shapes = jax.eval_shape(lambda: enc.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((2, P, P, C1)),
        jnp.zeros((2, P, P, C2)), train=False))
    online = seeded_variables(flax.core.unfreeze(shapes), seed=0)
    key_vars = seeded_variables(flax.core.unfreeze(shapes), seed=1)
    state = jax_moco.init_moco_state(online, QUEUE, D)
    state = state.replace(key_variables=key_vars,
                          queue_ptr=jnp.int32(QUEUE - B))
    rng = np.random.RandomState(2)
    views = [rng.rand(B, P, P, c).astype(np.float32)
             for c in (C1, C1, C2, C2)]
    return enc, online, state, views


def _port(online, state, dtype=torch.float32):
    tm = DualModalEncoder(C1, C2, embed_dim=D)
    tm.load_state_dict(flax_to_state_dict(online, tm))
    tm.to(dtype).train()
    moco = flax_to_moco_state(flax.serialization.to_state_dict(
        jax.device_get(state)), tm)
    moco.key_variables = {k: v.to(dtype)
                          for k, v in moco.key_variables.items()}
    moco.queue = moco.queue.to(dtype)
    return tm, moco


# --------------------------------------------------------------------------
# the two-view pipeline
# --------------------------------------------------------------------------

def test_twoview_covers_every_interior_pixel_and_view_1_is_raw():
    img1, img2, gt = _scene()
    pipe = TwoViewPipeline(img1, img2, gt, P, [0], 5, augment=AugmentConfig(
        flip=True, radiation=True, mixture=True))
    h, w = gt.shape
    half = P // 2
    want = {(x, y) for x in range(half + 1, h - half)
            for y in range(half + 1, w - half)}
    assert {tuple(c) for c in pipe.indices} == want == {
        tuple(c) for c in JaxTwoView(img1, img2, gt, P, [0], 5).indices}
    centers = torch.from_numpy(pipe.indices[:16])
    v1_1, v1_2, v2_1, v2_2, labels = pipe.make_views(
        torch.Generator().manual_seed(0), centers)
    for i, (x, y) in enumerate(pipe.indices[:16]):
        np.testing.assert_array_equal(
            v1_1[i].numpy(), img1[x - half:x + half + 1, y - half:y + half + 1])
        np.testing.assert_array_equal(
            v2_1[i].numpy(), img2[x - half:x + half + 1, y - half:y + half + 1])
        assert labels[i] == gt[x, y]
    assert not torch.equal(v1_1, v1_2)
    assert v2_2.shape == v2_1.shape == (16, P, P, C2)


@pytest.mark.parametrize("radiation,mixture", [(True, True), (False, False)])
def test_twoview_matches_jax_on_its_draws(radiation, mixture):
    img1, img2, gt = _scene(3)
    jp = JaxTwoView(img1, img2, gt, P, [0], 5, augment=JaxAugment(
        flip=True, radiation=radiation, mixture=mixture))
    tp = TwoViewPipeline(img1, img2, gt, P, [0], 5, augment=AugmentConfig(
        flip=True, radiation=radiation, mixture=mixture))
    centers = np.random.RandomState(4).permutation(jp.indices)[:64]
    key = jax.random.PRNGKey(7)
    want = jax.jit(jp.make_views)(key, jnp.asarray(centers))
    codes, draws = jax.jit(lambda k: _jax_draws(
        k, jp.augment_cfg, 64, (P, P, C1), jnp.float32, fold=False))(key)
    got = tp.make_views(None, torch.from_numpy(centers),
                        codes=torch.from_numpy(np.asarray(codes, np.int64)),
                        draws={k: torch.tensor(np.asarray(v))
                               for k, v in draws.items()})
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))


# --------------------------------------------------------------------------
# the MoCo model
# --------------------------------------------------------------------------

def test_encoder_and_moco_state_convert_both_ways(case):
    _, online, state, _ = case
    tm, moco = _port(online, state)
    back = state_dict_to_flax(tm)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, online)
    tree = flax.serialization.to_state_dict(jax.device_get(state))
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           moco_state_to_flax(tm, moco), tree)
    assert moco.queue_ptr == QUEUE - B


def test_moco_forward_matches_jax(case):
    enc, online, state, views = case
    want = jax.jit(lambda v, s, *x: jax_moco.moco_forward(enc, v, s, *x))(
        online, state, *views)
    tm, moco = _port(online, state)
    logits, target, k, new = moco_forward(
        tm, moco, *(torch.from_numpy(v) for v in views))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want[0]),
                               rtol=RTOL, atol=RTOL * float(
                                   np.abs(want[0]).max()))
    np.testing.assert_array_equal(target.numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(k.numpy(), np.asarray(want[2]), rtol=RTOL,
                               atol=ATOL)
    got_state = moco_state_to_flax(tm, new)
    want_state = flax.serialization.to_state_dict(jax.device_get(want[3]))
    assert int(got_state["queue_ptr"]) == int(want_state["queue_ptr"]) == 0
    np.testing.assert_allclose(got_state["queue"], want_state["queue"],
                               rtol=RTOL, atol=ATOL)
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL),
        got_state["key_variables"], want_state["key_variables"])
    # the online encoder's statistics are untouched by both forwards
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           state_dict_to_flax(tm)["batch_stats"],
                           online["batch_stats"])


def test_pretrain_step_matches_jax_in_float64(case):
    enc, online, state, views = case
    lr = 3e-3
    valid = np.ones(B)
    valid[-1] = 0.0                             # a padded last row

    tm, _ = _port(online, state, torch.float64)
    img1, img2, gt = _scene()
    pre = Pretrainer(tm, {"batch_size": B, "epoch": 1, "lr": lr},
                     TwoViewPipeline(img1, img2, gt, P, [0], 5),
                     queue_size=QUEUE, embed_dim=D, save_checkpoints=False)
    pre.moco = _port(online, state, torch.float64)[1]
    loss = pre.loss([torch.from_numpy(v.astype(np.float64)) for v in views],
                    torch.from_numpy(valid))
    pre.optimizer.zero_grad()
    loss.backward()
    grads = {k: p.grad.clone() for k, p in tm.named_parameters()}
    pre.optimizer.step()

    with jax.enable_x64(True):
        # the pointer too: x64 makes dynamic_update_slice's 0 an int64
        as64 = lambda t: jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64 if jnp.issubdtype(
                jnp.asarray(a).dtype, jnp.floating) else jnp.int64), t)
        variables, s64 = as64(online), as64(state)
        x64 = [jnp.asarray(v, jnp.float64) for v in views]

        def loss_fn(params):
            logits, target, _, new = jax_moco.moco_forward(
                enc, {**variables, "params": params}, s64, *x64)
            losses = optax.softmax_cross_entropy_with_integer_labels(
                logits, target)
            return jnp.sum(losses * valid) / jnp.maximum(
                jnp.sum(valid), 1.0), new

        (want_loss, new), want_grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(variables["params"])
        tx = optax.adam(lr)
        updates, _ = tx.update(want_grads, tx.init(variables["params"]),
                               variables["params"])
        want_params = optax.apply_updates(variables["params"], updates)
        to_np = lambda t: jax.tree_util.tree_map(np.asarray,
                                                 jax.device_get(t))
        want_g = flax_to_state_dict({"params": to_np(want_grads)}, tm,
                                    expected=dict(tm.named_parameters()))
        want_p = flax_to_state_dict({"params": to_np(want_params)}, tm,
                                    expected=dict(tm.named_parameters()))
        want_key = to_np(new.key_variables)
        want_queue = np.asarray(new.queue)

    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=TOL64)
    for k, p in tm.named_parameters():
        for got, want in ((grads[k], want_g[k]), (p.detach(), want_p[k])):
            err = float((got - want).norm())
            assert err <= TOL64 * float(want.norm()) + 1e-15, (k, err)
    got_state = moco_state_to_flax(tm, pre.moco)
    np.testing.assert_allclose(got_state["queue"], want_queue, rtol=TOL64,
                               atol=1e-12)
    jax.tree_util.tree_map(
        lambda g, w: np.testing.assert_allclose(g, w, rtol=TOL64, atol=0),
        got_state["key_variables"], want_key)


# --------------------------------------------------------------------------
# the loop
# --------------------------------------------------------------------------

def test_epoch_leaves_the_running_statistics_and_saves_jax_readable_files(
        tmp_path):
    img1, img2, gt = _scene()
    pipe = TwoViewPipeline(img1, img2, gt, P, [0], 5, augment=AugmentConfig(
        flip=True, radiation=True, mixture=True))
    tm = init_parameters(DualModalEncoder(C1, C2, embed_dim=D), 3)
    stats = {k: v.clone() for k, v in tm.named_buffers()}
    pre = Pretrainer(tm, {"batch_size": 16, "epoch": 2, "lr": 1e-3,
                          "cos": True}, pipe, queue_size=40, embed_dim=D,
                     seed=5, checkpoint_root=str(tmp_path), savename="X")
    assert pre.moco.queue.shape == (48, D)          # rounded up to 3 batches
    queue0 = pre.moco.queue.clone()
    best = pre.fit(dataset_name="Synthetic")
    assert len(pre.losses) == 2 and np.isfinite(pre.losses).all()
    assert not torch.equal(queue0, pre.moco.queue)
    assert torch.allclose(pre.moco.queue.norm(dim=1),
                          torch.ones(48), atol=1e-5)
    # 99 centers, 7 steps of 16: the pointer moved 7 x 16 mod 48 an epoch
    assert pre.moco.queue_ptr == (2 * 7 * 16) % 48
    for k, v in tm.named_buffers():
        assert torch.equal(v, stats[k]) and torch.equal(best[k], stats[k]), k

    path = pre.best_checkpoint
    assert os.path.dirname(path) == str(
        tmp_path / "dualmodalencoder" / "Synthetic" / "pre_train" /
        "best_epoch")
    assert os.path.basename(path).endswith("X_run0_epoch{}_{:.2f}.msgpack"
                                           .format(1 + int(pre.losses[1] <=
                                                           pre.losses[0]),
                                                   min(pre.losses)))
    enc = jax_moco.DualModalEncoder(embed_dim=D)
    target = flax.core.unfreeze(enc.init(
        {"params": jax.random.PRNGKey(1)}, jnp.zeros((2, P, P, C1)),
        jnp.zeros((2, P, P, C2)), train=False))
    restored = jax_ckpt.restore_checkpoint(path, target)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           state_dict_to_flax(tm, best),
                           jax.device_get(restored))


@pytest.mark.parametrize("hp", [{"cos": True, "epoch": 100},
                                {"cos": False, "epoch": 100,
                                 "schedule_milestones": [10, 20]},
                                {"epoch": 7}])
def test_learning_rate_schedule_matches_jax(hp):
    for e in range(hp["epoch"] + 1):
        assert adjust_learning_rate(5e-4, e, hp) == \
            jax_pretrain.adjust_learning_rate(5e-4, e, hp)


def test_cli_pretrains_on_the_cpu(tmp_path, monkeypatch):
    for k, v in (("H", "14"), ("W", "16"), ("BANDS", "8"), ("CLASSES", "4")):
        monkeypatch.setenv("VCT_SYN_" + k, v)
    monkeypatch.chdir(tmp_path)
    out = io.StringIO()
    with redirect_stdout(out):
        result = cli.main([
            "--dataset", "Synthetic", "--folder", str(tmp_path), "--device",
            "cpu", "--pretrain", "--serve", "--cos", "--epoch", "2",
            "--batch_size", "16", "--queue_size", "40", "--patch_size", "5",
            "--radiation_augmentation", "--mixture_augmentation",
            "--log_every", "0"])
    assert json.loads(out.getvalue()) == result
    assert result["queue_size"] == 48 and result["centers"] == 99
    assert len(result["losses"]) == 2 and np.isfinite(result["losses"]).all()
    assert result["best_checkpoint"].startswith(
        "./checkpoints/dualmodalencoder/Synthetic/pre_train/best_epoch/")
    assert os.path.isfile(result["best_checkpoint"])
    args = cli.build_parser().parse_args(["--pretrain"])
    assert args.device == "cuda" and args.queue_size == 2048
