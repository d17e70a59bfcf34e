"""Training the transformer zoo in the port against the JAX package, on
the CPU.

* The noise source and flax's Dropout: identity in eval mode and at rate
  0, zeros at rate 1, the kept share within 3 sigma of 1 - rate and the
  kept values scaled by 1 / (1 - rate), one seed one mask; a draw outside
  ``noise.drawing`` raises.
* MHST's ``gumbel_sigmoid`` against the JAX function given the same two
  uniforms (``jax.random.uniform`` patched): values and the
  straight-through gradient.
* One train step of each zoo model (MHST with ``attn_drop`` 0.1, the
  unfused attention with dropout on its probabilities, and 0, the pooled
  kernel's path; SpectralFormer; S2EFT; GLT_Net with its ``glt`` loss) at
  small widths, port against JAX under shared noise: the port draws from a
  ``noise.Recorder``; JAX gets the same dropout masks through
  ``flax.linen.intercept_methods`` around ``nn.Dropout`` and the same
  Gumbel uniforms through a patched ``jax.random.uniform``, in call order.
  Same seeded flax variables (convert.py), a padded last row (valid 0)
  and a class of weight 0.
* ``glt`` with a padded ``valid`` and ``sgd`` against the JAX package.
* ``run_experiments`` of a zoo model on a tiny Synthetic scene: its best
  file restores strictly in the JAX package, and a resumed run repeats
  the unbroken one bit for bit, noise included; the CLI trains each zoo
  model for one step.

Tolerances (those of tests/test_torch_train_step.py).
* float64 (JAX under ``enable_x64``): loss, BatchNorm statistics and every
  gradient within 1e-7 relative (per tensor in norm, plus 1e-12 of the
  largest gradient norm for gradients that vanish). The JAX package's
  ``ln_groups_reference`` (MHST's pooled LayerNorm) computes in float32
  whatever its input; the float64 step swaps in the same formula at the
  input's width (the port's own ``ln_groups_reference``).
* float32: loss and statistics rtol 2e-4 / atol 2e-5 against JAX's
  float32 step; gradients ||port - jax64|| <= 5e-2 ||jax64|| + 1e-5
  max_k ||jax64_k||, the flagship's conditioning-bound limit.
"""

import json
import os

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from vit_cnn_tpu.models import mhst as jax_mhst
from vit_cnn_tpu.models.glt_net import GLTNet as JaxGLT
from vit_cnn_tpu.models.s2eft import S2EFT as JaxS2EFT
from vit_cnn_tpu.models.spectralformer import SpectralFormer as JaxSF
from vit_cnn_tpu.ops import attention as jax_attention
from vit_cnn_tpu.train import losses as jax_losses
from vit_cnn_tpu.train import optim as jax_optim
from vit_cnn_tpu_torch import cli
from vit_cnn_tpu_torch.convert import flax_to_state_dict, seeded_variables
from vit_cnn_tpu_torch.models.glt_net import GLTNet
from vit_cnn_tpu_torch.models.mhst import MHST, gumbel_sigmoid
from vit_cnn_tpu_torch.models.s2eft import S2EFT
from vit_cnn_tpu_torch.models.spectralformer import SpectralFormer
from vit_cnn_tpu_torch.nn import noise
from vit_cnn_tpu_torch.train import checkpoint as ckpt
from vit_cnn_tpu_torch.train.losses import LOSSES, glt_loss
from vit_cnn_tpu_torch.train.optim import OptimizerSpec, build_optimizer

TOL64, FLOOR64 = 1e-7, 1e-12
RTOL, ATOL = 2e-4, 2e-5
GRAD_RTOL, GRAD_FLOOR = 5e-2, 1e-5
K, BATCH = 5, 4
ZOO = ("MHST", "SpectralFormer", "S2EFT", "GLT_Net")


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread, as tests/test_torch_runloop.py: the steps do
    not stall when the suite's workers share the cores, and the CPU's
    float32 step is bitwise repeatable (the resume test)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------
# the noise source and Dropout
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rate,training", [(0.3, False), (0.0, True)])
def test_dropout_is_the_identity_in_eval_and_at_rate_0(rate, training):
    drop = noise.Dropout(rate).train(training)
    x = torch.randn(6, 7)
    assert drop(x) is x                # and draws nothing: no source set


def test_dropout_at_rate_1_gives_zeros():
    x = torch.randn(6, 7)
    assert torch.equal(noise.Dropout(1.0).train()(x), torch.zeros_like(x))


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keeps_one_minus_rate_and_scales(rate):
    n = 200_000
    x = torch.rand(n) + 0.5
    with noise.drawing(torch.Generator().manual_seed(3)):
        y = noise.Dropout(rate).train()(x)
    kept = y != 0
    share = float(kept.double().mean())
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(share - (1 - rate)) < 3 * sigma
    torch.testing.assert_close(y[kept], x[kept] / (1 - rate), rtol=0,
                               atol=0)


def test_same_seed_same_mask_and_no_draw_outside_a_source():
    x = torch.ones(64, 33)
    masks = []
    for seed in (5, 5, 6):
        with noise.drawing(torch.Generator().manual_seed(seed)):
            masks.append(noise.Dropout(0.4).train()(x) != 0)
    assert torch.equal(masks[0], masks[1])
    assert not torch.equal(masks[0], masks[2])
    with pytest.raises(RuntimeError, match="noise.drawing"):
        noise.Dropout(0.4).train()(x)


def test_recorder_and_replay_hand_out_the_same_draws():
    rec = noise.Recorder(torch.Generator().manual_seed(1))
    with noise.drawing(rec):
        a = noise.uniform((3, 4), "cpu", 1e-10, 1.0)
        b = noise.uniform((5,), "cpu")
    rep = noise.Replay(rec.draws)
    with noise.drawing(rep):
        assert torch.equal(noise.uniform((3, 4), "cpu", 1e-10, 1.0), a)
        with pytest.raises(RuntimeError, match="shape"):
            noise.uniform((4,), "cpu")
        assert torch.equal(noise.uniform((5,), "cpu"), b)
    assert float(a.min()) >= 1e-10


# --------------------------------------------------------------------------
# JAX under the port's noise
# --------------------------------------------------------------------------

class _Shared:
    """Hands the port's recorded draws to JAX in call order: the dropout
    masks (u < 1 - rate, computed as the port computes them) through an
    interceptor of ``nn.Dropout``, the Gumbel uniforms through a patched
    ``jax.random.uniform``."""

    def __init__(self, draws):
        self.draws = list(draws)
        self.taken = 0

    def take(self, shape):
        u = self.draws[self.taken]
        assert tuple(u.shape) == tuple(shape), (self.taken, u.shape, shape)
        self.taken += 1
        return u

    def uniform(self, key, shape, dtype=float, minval=0.0, maxval=1.0):
        return jnp.asarray(self.take(shape).numpy(), dtype)

    def interceptor(self, next_fun, args, kwargs, context):
        mod = context.module
        if not isinstance(mod, fnn.Dropout) or \
                context.method_name != "__call__":
            return next_fun(*args, **kwargs)
        x = args[0]
        det = fnn.merge_param("deterministic", mod.deterministic,
                              kwargs.get("deterministic"))
        if det or mod.rate == 0.0:
            return x
        keep_prob = 1.0 - mod.rate
        keep = (self.take(x.shape) < keep_prob).numpy()
        return jax.lax.select(jnp.asarray(keep), x / keep_prob,
                              jnp.zeros_like(x))


def _jax_ln_groups_wide(x, gamma, beta, hd, eps=1e-5):
    """The JAX package's ln_groups_reference at the input's width."""
    b, n, c = x.shape
    xf = x.reshape(b, n, c // hd, hd)
    mu = jnp.mean(xf, -1, keepdims=True)
    var = jnp.maximum(jnp.mean(xf * xf, -1, keepdims=True) - mu * mu, 0.0)
    y = (xf - mu) * jax.lax.rsqrt(var + eps) * gamma + beta
    return y.reshape(b, n, c)


def test_gumbel_sigmoid_matches_jax():
    """Train mode given the same uniforms, and eval: the values and the
    straight-through gradient d(sum(w * y)) / d logits."""
    rng = np.random.RandomState(0)
    logits = rng.randn(64, 16).astype(np.float32) * 3
    w = rng.randn(64, 16).astype(np.float32)
    for training in (True, False):
        rec = noise.Recorder(torch.Generator().manual_seed(2))
        lt = torch.tensor(logits, requires_grad=True)
        with noise.drawing(rec):
            y = gumbel_sigmoid(lt, 5.0, training)
        (y * torch.from_numpy(w)).sum().backward()
        shared = _Shared(rec.draws)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "uniform", shared.uniform)
            fn = lambda x: jax_mhst.gumbel_sigmoid(
                jax.random.PRNGKey(0), x, 5.0, training=training)
            want, vjp = jax.vjp(fn, jnp.asarray(logits))
        assert shared.taken == len(rec.draws) == (2 if training else 0)
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(lt.grad.numpy(),
                                   np.asarray(vjp(jnp.asarray(w))[0]),
                                   rtol=1e-5, atol=1e-8)
        hard = np.asarray(want) > 0.5
        assert hard.any() and (~hard).any()


# name -> (JAX module, port module, hsi bands, lidar bands, patch), at small
# widths; MHST and GLT_Net keep dim 64 (their encoders' width)
def _models(name):
    if name.startswith("MHST"):
        attn_drop = 0.0 if name.endswith("0") else 0.1
        kw = dict(n_bands1=10, n_bands2=1, patch_size=8, n_classes=K,
                  en_depth=1, hsp_vit_depth=2, attn_drop=attn_drop)
        return JaxMHST(num_patches=64, **kw), MHST(**kw), 10, 1, 8
    if name == "SpectralFormer":
        kw = dict(num_patches=11, n_classes=K, dim=32, depth=2, heads=2)
        return JaxSF(**kw), SpectralFormer(**kw), 10, 1, 1
    if name == "S2EFT":
        kw = dict(num_patches=10, patch_size=3, n_classes=K, dim=32,
                  depth=3, heads=2)
        return JaxS2EFT(**kw), S2EFT(**kw), 10, 1, 3
    kw = dict(n_bands1=6, n_bands2=1, patch_size=4, n_classes=K,
              en_depth=2, de_depth=2)
    return JaxGLT(num_patches=16, **kw), GLTNet(**kw), 6, 1, 4


JaxMHST = jax_mhst.MHST
STEP_CASES = ("MHST attn_drop 0.1", "MHST attn_drop 0", "SpectralFormer",
              "S2EFT", "GLT_Net")


def _loss_name(name):
    return "glt" if name == "GLT_Net" else "cross_entropy"


@pytest.fixture(scope="module", params=STEP_CASES)
def steps(request):
    name = request.param
    jm, tm0, n1, n2, p = _models(name)
    rng = np.random.RandomState(1)
    hsi = rng.rand(BATCH, p, p, n1).astype(np.float32)
    lidar = rng.rand(BATCH, p, p, n2).astype(np.float32)
    labels = np.array([1, 3, 0, 4])
    weights = np.array([0, 1, 1, 0.5, 2], np.float32)
    valid = np.array([1, 1, 1, 0], np.float32)
    key = jax.random.PRNGKey(0)
    init = flax.core.unfreeze(jax.eval_shape(lambda: jm.init(
        {"params": key, "dropout": key}, jnp.asarray(hsi),
        jnp.asarray(lidar), train=False)))
    tree = seeded_variables(init, seed=0)
    loss_name = _loss_name(name)

    def port_step(dtype, source):
        tm = _models(name)[1]
        tm.load_state_dict(flax_to_state_dict(tree, tm))
        tm.to(dtype).train()
        with noise.drawing(source):
            out = tm(torch.from_numpy(hsi).to(dtype),
                     torch.from_numpy(lidar).to(dtype))
        loss = LOSSES[loss_name](out, torch.from_numpy(labels),
                                 torch.from_numpy(weights).to(dtype),
                                 torch.from_numpy(valid).to(dtype))
        loss.backward()
        return float(loss.detach()), tm

    def jax_step(dtype, draws):
        cast = lambda t: jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, dtype), t)
        variables = cast(tree)
        shared = _Shared(draws)

        def loss_fn(params):
            out, upd = jm.apply(
                dict(variables, params=params),
                jnp.asarray(hsi, dtype), jnp.asarray(lidar, dtype),
                train=True, mutable=["batch_stats"], rngs={"dropout": key})
            return jax_losses.LOSSES[loss_name](
                out, jnp.asarray(labels), jnp.asarray(weights, dtype),
                jnp.asarray(valid, dtype)), upd

        with pytest.MonkeyPatch.context() as mp, \
                fnn.intercept_methods(shared.interceptor):
            mp.setattr(jax.random, "uniform", shared.uniform)
            if dtype == jnp.float64:
                for mod in (jax_attention, jax_mhst):
                    mp.setattr(mod, "ln_groups_reference",
                               _jax_ln_groups_wide)
            (loss, upd), grads = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True))(variables["params"])
        assert shared.taken == len(draws)
        as64 = lambda t: jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), jax.device_get(t))
        want = flax_to_state_dict(
            {"params": as64(grads),
             "batch_stats": as64(upd.get("batch_stats", {}))},
            _models(name)[1].double())
        return float(loss), want

    rec = noise.Recorder(torch.Generator().manual_seed(7))
    port64 = port_step(torch.float64, rec)
    port32 = port_step(torch.float32, noise.Replay(rec.draws))
    with jax.enable_x64(True):
        jax64 = jax_step(jnp.float64, rec.draws)
    return {"name": name, "draws": rec.draws, "port64": port64,
            "port32": port32, "jax64": jax64,
            "jax32": jax_step(jnp.float32, rec.draws)}


def _stats(tm):
    return {k: v for k, v in tm.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _check_grads(tm, want, rtol, floor_share):
    """Every parameter's gradient against ``want``; only S2EFT's gate conv
    (behind the hard gate) has none, and JAX's is zero there."""
    params = dict(tm.named_parameters())
    floor = floor_share * max(float(want[k].norm()) for k in params)
    for k, p in params.items():
        if p.grad is None:
            assert k.startswith("gate_conv."), k
            assert float(want[k].abs().max()) == 0.0, k
            continue
        err = float((p.grad.double() - want[k]).norm())
        assert err <= rtol * float(want[k].norm()) + floor, (
            k, err, float(want[k].norm()))


def test_float64_step_matches_jax(steps):
    name = steps["name"]
    loss, want = steps["jax64"]
    got, tm = steps["port64"]
    assert got == pytest.approx(loss, rel=TOL64)
    stats = _stats(tm)
    assert set(stats) == {k for k in want if k.endswith(
        ("running_mean", "running_var"))}
    assert bool(stats) == name.startswith(("MHST", "GLT"))
    for k, v in stats.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=TOL64,
                                   atol=0, err_msg=k)
    _check_grads(tm, want, TOL64, FLOOR64)
    # the noise mattered: dropout masks (and for MHST Gumbel uniforms) drawn
    assert len(steps["draws"]) > 0


def test_float32_step_matches_jax(steps):
    """The float32 loss and statistics against JAX's float32 step, the
    gradients against its float64 step at the conditioning-bound limit."""
    loss, want32 = steps["jax32"]
    got, tm = steps["port32"]
    assert got == pytest.approx(loss, rel=RTOL, abs=ATOL)
    for k, v in _stats(tm).items():
        np.testing.assert_allclose(v.numpy(), want32[k].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    _check_grads(tm, steps["jax64"][1], GRAD_RTOL, GRAD_FLOOR)


# --------------------------------------------------------------------------
# the glt loss and sgd
# --------------------------------------------------------------------------

def test_glt_loss_matches_jax_with_a_padded_valid():
    """valid masks the cross-entropy, not con_loss (as in JAX)."""
    rng = np.random.RandomState(4)
    logits = rng.randn(6, K).astype(np.float32)
    labels = np.array([0, 1, 2, 3, 4, 1])
    weights = np.array([1, 0.5, 2, 1, 0], np.float32)
    valid = np.array([1, 1, 1, 1, 0, 0], np.float32)
    con = np.float32(0.37)
    got = glt_loss((torch.from_numpy(logits), torch.tensor(con)),
                   torch.from_numpy(labels), torch.from_numpy(weights),
                   torch.from_numpy(valid))
    want = jax_losses.glt_loss((jnp.asarray(logits), jnp.asarray(con)),
                               jnp.asarray(labels), jnp.asarray(weights),
                               jnp.asarray(valid))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert LOSSES["glt"] is glt_loss


@pytest.mark.parametrize("momentum,wd", [(0.9, 1e-2), (0.0, 0.0)])
def test_sgd_matches_the_optax_chain(momentum, wd):
    """Five steps of torch SGD against ``build_optimizer`` of the JAX
    package (add_decayed_weights, trace, scale_by_learning_rate), float64,
    a constant rate."""
    rng = np.random.RandomState(5)
    w0 = rng.randn(7, 3)
    grads = [rng.randn(7, 3) for _ in range(5)]
    spec = dict(name="sgd", lr=0.1, weight_decay=wd, step_size=None)
    w = torch.tensor(w0, requires_grad=True)
    opt = build_optimizer(OptimizerSpec(momentum=momentum, **spec), [w])
    with jax.enable_x64(True):
        tx = jax_optim.build_optimizer(
            jax_optim.OptimizerSpec(momentum=momentum, **spec), 1)
        params = jnp.asarray(w0)
        state = tx.init(params)
        for g in grads:
            w.grad = torch.tensor(g)
            opt.step()
            upd, state = tx.update(jnp.asarray(g), state, params)
            params = optax.apply_updates(params, upd)
            np.testing.assert_allclose(w.detach().numpy(),
                                       np.asarray(params), rtol=1e-12,
                                       atol=1e-14)


# --------------------------------------------------------------------------
# the run loop and the CLI
# --------------------------------------------------------------------------

SCENE = {"VCT_SYN_H": "14", "VCT_SYN_W": "16", "VCT_SYN_BANDS": "8",
         "VCT_SYN_CLASSES": "4"}


def _args(tmp_path, model, *extra):
    return cli.build_parser().parse_args([
        "--dataset", "Synthetic", "--folder", str(tmp_path), "--device",
        "cpu", "--model", model, "--batch_size", "32", "--training_sample",
        "30", "--infer_chunk", "64", "--log_every", "0", "--out_dir",
        str(tmp_path / "results"), *extra])


@pytest.fixture
def scene_env(monkeypatch, tmp_path):
    for k, v in SCENE.items():
        monkeypatch.setenv(k, v)
    monkeypatch.chdir(tmp_path)               # ./checkpoints


@pytest.mark.parametrize("model", ZOO)
def test_cli_trains_a_zoo_model_on_the_cpu(tmp_path, scene_env, monkeypatch,
                                           model):
    """One epoch through run_train: finite losses, a report, the best and
    final files, and every parameter moved by its registry optimizer: the
    final file's parameters all differ from the initial ones, except
    S2EFT's gate conv, whose gradient is zero (under Adam it stays put)."""
    built = {}
    real_trainer = cli.Trainer

    def trainer(model, *a, **k):
        built["model"] = model
        built["initial"] = {n: p.detach().clone()
                            for n, p in model.named_parameters()}
        return real_trainer(model, *a, **k)

    monkeypatch.setattr(cli, "Trainer", trainer)
    args = _args(tmp_path, model, "--runs", "1", "--epoch", "1", "--bf16",
                 "--flip_augmentation")
    result = cli.run_train(args)
    assert result["epochs"] == 1 and np.isfinite(result["losses"]).all()
    assert 0.0 <= result["OA"] <= 100.0
    for key in ("best_checkpoint", "final_checkpoint"):
        assert os.path.exists(result[key])
    assert os.path.exists(tmp_path / "results" / "Synthetic_{}".format(
        model) / "report.txt")
    final = ckpt.restore_state_dict(result["final_checkpoint"],
                                    built["model"])
    assert built["initial"]
    for name, before in built["initial"].items():
        moved = not torch.equal(final[name].float(), before.float())
        assert moved != name.startswith("gate_conv."), name


def _jax_variables(model, tmp_path):
    """The JAX package's variables for ``model`` on the SCENE's bands."""
    from vit_cnn_tpu.models import registry as jax_registry

    bands = int(SCENE["VCT_SYN_BANDS"])
    jm, spec, _ = jax_registry.get_model(
        model, n_classes=int(SCENE["VCT_SYN_CLASSES"]),
        n_bands=(bands, 1))
    p = spec.patch_size
    key = jax.random.PRNGKey(0)
    return flax.core.unfreeze(jax.eval_shape(lambda: jm.init(
        {"params": key, "dropout": key}, jnp.zeros((2, p, p, bands)),
        jnp.zeros((2, p, p, 1)), train=False)))


def test_run_experiments_file_restores_in_jax(tmp_path, scene_env):
    """MHST (batch statistics, the Gumbel heads) through run_experiments:
    the best file is flax bytes of the JAX model's variables."""
    (result,) = cli.run_experiments(_args(tmp_path, "MHST", "--runs", "1",
                                          "--epoch", "2"))
    target = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), _jax_variables("MHST",
                                                             tmp_path))
    with open(result["best_checkpoint"], "rb") as f:
        restored = serialization.from_bytes(target, f.read())
    assert set(restored) == {"params", "batch_stats"}
    flat = jax.tree_util.tree_leaves(restored)
    assert len(flat) == len(jax.tree_util.tree_leaves(target))
    assert any(np.abs(x).max() > 0 for x in
               jax.tree_util.tree_leaves(restored["batch_stats"]))
    report = open(tmp_path / "results" / "Synthetic_MHST" / "report.txt")
    assert "Kappa" in report.read()


def _trainer(tmp_path, seed, epochs):
    """GLT_Net (dropout in both backbones, the glt loss) on the SCENE with
    flip on, 2 batches of 16 an epoch."""
    from vit_cnn_tpu_torch.data import get_dataset
    from vit_cnn_tpu_torch.models.registry import get_model
    from vit_cnn_tpu_torch.nn.layers import init_parameters
    from vit_cnn_tpu_torch.pipeline.patches import (AugmentConfig,
                                                    PatchPipeline)
    from vit_cnn_tpu_torch.train.loop import Trainer

    img1, img2, gt = get_dataset("Synthetic", str(tmp_path))[:3]
    n_classes = int(SCENE["VCT_SYN_CLASSES"])
    model, _, hp = get_model("GLT_Net", n_classes=n_classes,
                             n_bands=(img1.shape[2], 1), ignored_labels=[0],
                             batch_size=16, epoch=epochs)
    init_parameters(model, 0)
    gt = gt.copy()
    gt[8:] = 0
    pipe = PatchPipeline(img1, img2, gt, hp["patch_size"], [0], n_classes,
                         augment=AugmentConfig(flip=True))
    assert 16 < len(pipe) <= 32
    return Trainer(model, hp, pipe, seed=seed,
                   checkpoint_root=str(tmp_path / "ck"), savename="GLT_Net")


def test_resume_repeats_the_unbroken_run_noise_included(tmp_path, scene_env):
    """3 unbroken epochs against 2 + save + restore into a trainer of
    another seed + 1: the same losses and weights bit for bit, so the
    resumed run drew the same dropout masks."""
    tr_a = _trainer(tmp_path, 0, 3)
    tr_a.fit(dataset_name="Synthetic")
    tr_b = _trainer(tmp_path, 0, 2)
    tr_b.fit(dataset_name="Synthetic")
    path = tr_b.save_resumable(str(tmp_path / "resume" / "ckpt"), epoch=2)
    tr_c = _trainer(tmp_path, 123, 3)
    start = tr_c.restore_resumable(path)
    assert start == 2
    tr_c.fit(dataset_name="Synthetic", start_epoch=start)
    assert tr_c.log.losses == tr_a.log.losses[2:]
    for k, v in tr_a.model.state_dict().items():
        assert torch.equal(tr_c.model.state_dict()[k], v), k
    assert torch.equal(tr_c.generator.get_state(), tr_a.generator.get_state())
    # another noise seed trains otherwise
    tr_d = _trainer(tmp_path, 0, 3)
    tr_d.restore_resumable(path)
    tr_d.generator.manual_seed(99)
    tr_d.fit(dataset_name="Synthetic", start_epoch=start)
    assert tr_d.log.losses != tr_a.log.losses[2:]
    with open(path + ".meta.json") as f:
        assert "generator" in json.load(f)
    assert ckpt.restore_checkpoint(path)["step"] == tr_b.steps_done


@pytest.mark.parametrize("model", ZOO)
def test_bf16_step_keeps_float32_state_and_restores_strictly(
        tmp_path, scene_env, model):
    """A bf16 step (bf16_train_apply over float32 master weights) leaves
    every parameter, gradient and BatchNorm statistic float32, the
    statistics moved; the train state then restores strictly into a
    trainer of another seed, moments and generator included."""
    from vit_cnn_tpu_torch import tools
    from vit_cnn_tpu_torch.data import get_dataset

    scene = get_dataset("Synthetic", str(tmp_path))[:3]
    state = tools.model_state(scene, model)
    trainer, args = tools.train_step(scene, state, "cpu", 8, model=model,
                                     bf16=True, flip=True)
    assert torch.isfinite(trainer._step(*args))
    net = trainer.model
    for k, p in net.named_parameters():
        assert torch.isfinite(p).all(), k
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in net.parameters())
    stats = {k: v for k, v in net.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    assert all(v.dtype == torch.float32 for v in stats.values())
    assert all(not torch.equal(v, state[k]) for k, v in stats.items())
    assert bool(stats) == (model in ("MHST", "GLT_Net"))
    path = trainer.save_resumable(str(tmp_path / "state"), epoch=1)
    other, _ = tools.train_step(scene, state, "cpu", 8, model=model,
                                bf16=True, seed=5)
    assert other.restore_resumable(path) == 1
    for k, v in net.state_dict().items():
        assert torch.equal(other.model.state_dict()[k], v), k
    params = dict(other.model.named_parameters())
    for k, p in net.named_parameters():
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(other.optimizer.state[params[k]][key],
                               trainer.optimizer.state[p][key]), k
    assert torch.equal(other.generator.get_state(),
                       trainer.generator.get_state())
