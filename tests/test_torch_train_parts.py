"""The pieces of the port's training path against the JAX package, on the
CPU with seeded numpy inputs: train-mode BatchNorm against flax, the
patch pipeline (gather per flip/rotate code, interior centers, shuffle
order), the loss, the StepLR schedule, AdamW / Adam against optax, the
filled hyperparameters, the ground-truth split, and the bf16 train policy.

Tolerances: float32 ops rtol 2e-4 / atol 2e-5 (the JAX suite's); index
work (gathers, orders, splits, schedules) is exact; bf16 outputs within
one bf16 step (rtol = atol = 2e-2).
"""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vit_cnn_tpu.data.sampling import sample_gt as jax_sample_gt
from vit_cnn_tpu.models.registry import get_model as jax_get_model
from vit_cnn_tpu.pipeline import patches as jax_patches
from vit_cnn_tpu.train.losses import weighted_cross_entropy as jax_ce
from vit_cnn_tpu.train.optim import OptimizerSpec as JaxSpec
from vit_cnn_tpu.train.optim import build_lr_schedule as jax_schedule
from vit_cnn_tpu.train.optim import build_optimizer as jax_optimizer
from vit_cnn_tpu_torch.data.sampling import sample_gt
from vit_cnn_tpu_torch.models.mm_mamba import MultimodalityMamba
from vit_cnn_tpu_torch.models.registry import get_model
from vit_cnn_tpu_torch.nn.layers import ChannelLastBatchNorm, init_parameters
from vit_cnn_tpu_torch.pipeline import patches
from vit_cnn_tpu_torch.train import checkpoint as ckpt
from vit_cnn_tpu_torch.train.loop import Trainer, _pad_to_multiple
from vit_cnn_tpu_torch.train.losses import weighted_cross_entropy
from vit_cnn_tpu_torch.train.optim import (OptimizerSpec, build_lr_schedule,
                                           build_optimizer)

RTOL, ATOL = 2e-4, 2e-5


def _scene(seed=0, h=16, w=18, bands=5, classes=4):
    rng = np.random.RandomState(seed)
    img1 = rng.rand(h, w, bands).astype(np.float32)
    img2 = rng.rand(h, w, 1).astype(np.float32)
    gt = rng.randint(0, classes, (h, w)).astype(np.int64)
    return img1, img2, gt


# --------------------------------------------------------------------------
# train-mode BatchNorm
# --------------------------------------------------------------------------

def _bn_case(seed):
    rng = np.random.RandomState(seed)
    x = (1.5 + 2.0 * rng.randn(4, 5, 5, 6)).astype(np.float32)
    scale = (1.0 + 0.2 * rng.randn(6)).astype(np.float32)
    bias = (0.1 * rng.randn(6)).astype(np.float32)
    mean = (0.1 * rng.randn(6)).astype(np.float32)
    var = (1.0 + 0.3 * rng.rand(6)).astype(np.float32)
    cot = rng.randn(4, 5, 5, 6).astype(np.float32)
    return x, scale, bias, mean, var, cot


def _flax_bn(x, scale, bias, mean, var, cot, dtype=jnp.float32):
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    stats = {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}

    def f(x, scale, bias):
        y, upd = bn.apply({"params": {"scale": scale, "bias": bias},
                           "batch_stats": stats}, x, mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * cot), (y, upd)

    (_, (y, upd)), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                              has_aux=True)(
        *(jnp.asarray(a, dtype) for a in (x, scale, bias)))
    return y, upd["batch_stats"], grads


def _port_bn(x, scale, bias, mean, var, cot, dtype=torch.float32):
    bn = ChannelLastBatchNorm(6)
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
    params = [torch.from_numpy(a).to(dtype).requires_grad_()
              for a in (x, scale, bias)]
    y = torch.func.functional_call(
        bn.train(), {"weight": params[1], "bias": params[2]}, (params[0],))
    (y.float() * torch.from_numpy(cot)).sum().backward()
    return y, bn, [p.grad for p in params]


def test_train_batchnorm_matches_flax():
    """Output, updated running statistics (biased fast variance) and the
    gradients of x, scale and bias."""
    case = _bn_case(0)
    y_j, stats_j, grads_j = _flax_bn(*case)
    y_t, bn, grads_t = _port_bn(*case)
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats_j["mean"]), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats_j["var"]), rtol=RTOL,
                               atol=ATOL)
    for g_t, g_j in zip(grads_t, grads_j):
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=RTOL,
                                   atol=ATOL)


def test_train_batchnorm_is_not_torch_batch_norm():
    """torch's own train-mode update takes the unbiased variance; flax's,
    and the port's, the biased one."""
    x, scale, bias, mean, var, cot = _bn_case(1)
    _, bn, _ = _port_bn(x, scale, bias, mean, var, cot)
    rm, rv = torch.tensor(mean), torch.tensor(var)
    torch.nn.functional.batch_norm(
        torch.from_numpy(x).permute(0, 3, 1, 2), rm, rv, training=True,
        momentum=0.1, eps=1e-5)
    torch.testing.assert_close(bn.running_mean, rm)
    assert (bn.running_var - rv).abs().max() > 1e-3
    biased = 0.9 * var + 0.1 * x.reshape(-1, 6).var(axis=0)
    np.testing.assert_allclose(bn.running_var.numpy(), biased, rtol=RTOL)


def test_train_batchnorm_bf16_keeps_float32_statistics():
    case = _bn_case(2)
    y_j, stats_j, _ = _flax_bn(*case, dtype=jnp.bfloat16)
    y_t, bn, grads_t = _port_bn(*case, dtype=torch.bfloat16)
    assert y_t.dtype == torch.bfloat16 and y_j.dtype == jnp.bfloat16
    assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
    np.testing.assert_allclose(y_t.detach().float().numpy(),
                               np.asarray(y_j, np.float32), rtol=2e-2,
                               atol=2e-2)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats_j["var"]), rtol=RTOL,
                               atol=ATOL)
    assert all(g.dtype == torch.bfloat16 for g in grads_t)


# --------------------------------------------------------------------------
# patch pipeline
# --------------------------------------------------------------------------

@pytest.mark.parametrize("code", range(7))
def test_gather_with_each_geom_code_matches_jax(code):
    img1, img2, gt = _scene(1)
    p = 5
    pipe = patches.PatchPipeline(img1, img2, gt, p, [0], 4,
                                 augment=patches.AugmentConfig(flip=True))
    centers = pipe.indices[::7]
    codes = np.full(len(centers), code)
    gr, gc = jax_patches._geom_offset_grids(p)
    offsets = (jnp.asarray(gr)[codes], jnp.asarray(gc)[codes])
    want = [jax_patches.gather_patches(jnp.asarray(a), jnp.asarray(centers),
                                       p, offsets)
            for a in (img1, img2, gt[..., None].astype(np.int32))]
    got = pipe.make_batch(None, torch.from_numpy(centers), train=True,
                          codes=torch.from_numpy(codes))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(),
                                  np.asarray(want[2])[:, p // 2, p // 2, 0])
    # the offset grid is the transform of the identity patch
    plain = jax_patches.gather_patches(jnp.asarray(img1),
                                       jnp.asarray(centers), p)
    turned = jax.vmap(lambda a: jax_patches._geom_apply(a, code))(plain)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(turned))


def test_gather_clamps_like_jax():
    img1, _, _ = _scene(2)
    centers = np.array([[0, 0], [15, 17], [1, 16]], np.int32)
    want = jax_patches.gather_patches(jnp.asarray(img1), jnp.asarray(centers),
                                      5)
    got = patches.gather_patches(torch.from_numpy(img1),
                                 torch.from_numpy(centers), 5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_geom_codes_follow_the_reference_probabilities():
    """flip branch p=1/2 with independent lr / ud coins, else rotate by
    k in {1, 2, 3} with p=1/2: code 0 3/8, codes 1-3 1/8, codes 4-6 1/12."""
    g = torch.Generator().manual_seed(0)
    codes = patches.sample_geom_code(g, 60000)
    freq = np.bincount(codes.numpy(), minlength=7) / 60000
    want = np.array([3 / 8, 1 / 8, 1 / 8, 1 / 8, 1 / 12, 1 / 12, 1 / 12])
    np.testing.assert_allclose(freq, want, atol=0.01)
    jax_codes = jax.vmap(jax_patches.sample_geom_code)(
        jax.random.split(jax.random.PRNGKey(0), 60000))
    np.testing.assert_allclose(
        np.bincount(np.asarray(jax_codes), minlength=7) / 60000, want,
        atol=0.01)


def test_indices_table_and_epoch_order_match_jax():
    img1, img2, gt = _scene(3)
    np.testing.assert_array_equal(
        patches.interior_indices(gt, 5, [0]),
        jax_patches.interior_indices(gt, 5, [0]))
    np.testing.assert_array_equal(
        patches.interior_indices(gt, 7, [0], supervision="semi"),
        jax_patches.interior_indices(gt, 7, [0], supervision="semi"))
    idx = patches.interior_indices(gt, 5, [0])
    for got, want in zip(patches.build_class_index_table(gt, idx, 4),
                         jax_patches.build_class_index_table(gt, idx, 4)):
        np.testing.assert_array_equal(got, want)
    port = patches.PatchPipeline(img1, img2, gt, 5, [0], 4)
    ref = jax_patches.PatchPipeline(img1, img2, gt, 5, [0], 4)
    r1, r2 = np.random.RandomState(7), np.random.RandomState(7)
    for _ in range(2):
        np.testing.assert_array_equal(port.epoch_order(r1),
                                      ref.epoch_order(r2))
    labels = port.make_batch(None, torch.from_numpy(idx), train=False)[2]
    np.testing.assert_array_equal(labels.numpy(), gt[idx[:, 0], idx[:, 1]])


def test_pad_to_multiple_repeats_the_first_center():
    arr = np.arange(10).reshape(5, 2)
    padded, valid = _pad_to_multiple(arr, 4)
    np.testing.assert_array_equal(padded[5:], np.repeat(arr[:1], 3, axis=0))
    np.testing.assert_array_equal(valid, [1, 1, 1, 1, 1, 0, 0, 0])


# --------------------------------------------------------------------------
# loss, schedule, optimizers
# --------------------------------------------------------------------------

def test_weighted_cross_entropy_matches_jax():
    rng = np.random.RandomState(4)
    logits = rng.randn(9, 5).astype(np.float32)
    targets = rng.randint(0, 5, 9)
    weights = np.array([0, 1, 2, 0.5, 1], np.float32)
    valid = np.array([1, 1, 1, 1, 1, 1, 1, 0, 0], np.float32)
    for w, v in ((None, None), (weights, None), (weights, valid)):
        want = jax_ce(jnp.asarray(logits), jnp.asarray(targets),
                      None if w is None else jnp.asarray(w),
                      None if v is None else jnp.asarray(v))
        got = weighted_cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(targets),
            None if w is None else torch.from_numpy(w),
            None if v is None else torch.from_numpy(v))
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_step_lr_schedule_matches_jax():
    for step_size, spe in ((30, 3), (2, 5), (None, 4)):
        port = build_lr_schedule(OptimizerSpec(lr=8e-4, step_size=step_size,
                                               gamma=0.9), spe)
        ref = jax_schedule(JaxSpec(lr=8e-4, step_size=step_size, gamma=0.9),
                           spe)
        for step in (0, 1, 5, 29, 89, 90, 91, 400):
            want = ref(jnp.asarray(step)) if callable(ref) else ref
            # JAX evaluates the schedule in float32
            assert port(step) == pytest.approx(float(want), rel=1e-5)


@pytest.mark.parametrize("name,wd", [("adamw", 0.0), ("adamw", 0.05),
                                     ("adam", 0.0), ("adam", 5e-3)])
def test_optimizers_match_optax(name, wd):
    """torch AdamW / Adam through build_optimizer against the JAX
    package's optax chain, three steps on seeded gradients with the
    StepLR rate of each step."""
    rng = np.random.RandomState(5)
    shapes = [(4, 3), (3,)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    spec_kw = dict(name=name, lr=1e-2, weight_decay=wd, step_size=1,
                   gamma=0.5)
    tx = jax_optimizer(JaxSpec(**spec_kw), steps_per_epoch=2)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = build_optimizer(OptimizerSpec(**spec_kw), tp)
    schedule = build_lr_schedule(OptimizerSpec(**spec_kw), 2)
    for step, g in enumerate(grads):
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        for group in opt.param_groups:
            group["lr"] = schedule(step)
        opt.step()
    for p, want in zip(tp, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------
# hyperparameters, split, policy
# --------------------------------------------------------------------------

def test_get_model_fills_weights_and_augmentation_like_jax():
    kw = dict(n_classes=6, n_bands=(20, 1), ignored_labels=[0, 9])
    _, _, hp = get_model("Multimodality_Mamba", **kw)
    _, _, ref = jax_get_model("Multimodality_Mamba", **kw)
    np.testing.assert_array_equal(hp["weights"], ref["weights"])
    for key in ("flip_augmentation", "radiation_augmentation",
                "mixture_augmentation", "optimizer", "lr", "epoch",
                "batch_size", "patch_size", "loss", "center_pixel"):
        assert hp[key] == ref[key], key
    _, _, given = get_model("Multimodality_Mamba", weights=[1, 2], **kw)
    assert given["weights"] == [1, 2]


@pytest.mark.parametrize("mode,size", [("random", 0.3), ("random", 40),
                                       ("random", 0.95),
                                       ("random_fixednumber", 6)])
def test_sample_gt_matches_jax(mode, size):
    """The port's numpy split gives scikit-learn's (through the JAX
    sample_gt) for the same global numpy seed."""
    gt = _scene(6, h=30, w=30, classes=5)[2]
    np.random.seed(11)
    want = jax_sample_gt(gt, size, mode=mode, seed=3)
    np.random.seed(11)
    got = sample_gt(gt, size, mode=mode, seed=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_bf16_train_step_keeps_float32_parameters():
    """A bf16 step computes in bf16 (the classifier sees bf16), while the
    parameters, their gradients and the BatchNorm statistics stay
    float32 and the module is never cast."""
    img1, img2, gt = _scene(8, h=14, w=15, bands=6, classes=3)
    model, _, hp = get_model("Multimodality_Mamba", n_classes=3,
                             n_bands=(6, 1), ignored_labels=[0],
                             batch_size=4, epoch=1, bf16=True)
    init_parameters(model, 0)
    seen = []
    model.classifier.register_forward_hook(
        lambda m, args, out: seen.append(args[0].dtype))
    pipe = patches.PatchPipeline(img1, img2, gt, 9, [0], 3)
    trainer = Trainer(model, hp, pipe, seed=0)
    assert pipe.scene1.dtype == torch.bfloat16
    loss = trainer._step(torch.from_numpy(pipe.indices[:4]), torch.ones(4),
                         torch.zeros(()))
    assert seen == [torch.bfloat16] and torch.isfinite(loss)
    for name, t in list(model.named_parameters()) + list(
            model.named_buffers()):
        if t.is_floating_point():
            assert t.dtype == torch.float32, name
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in model.parameters())


def test_unported_training_options_raise(tmp_path):
    img1, img2, gt = _scene(9)
    with pytest.raises(ValueError, match="not implemented"):
        sample_gt(gt, 0.5, mode="spatial")
    model = MultimodalityMamba(5, 5, 1, 32, 4)
    pipe = patches.PatchPipeline(img1, img2, gt, 5, [0], 4)
    hp = {"batch_size": 2, "epoch": 1, "lr": 1e-3, "weights": np.ones(4)}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Trainer(model, dict(hp, loss="focal"), pipe)
    # sgd trains, and its (momentum-0, empty) state goes into a resumable
    # file (tests/test_torch_sgd_resume.py holds the momentum trace)
    sgd = Trainer(model, dict(hp, optimizer="sgd"), pipe)
    assert isinstance(sgd.optimizer, torch.optim.SGD)
    path = sgd.save_resumable(str(tmp_path / "sgd"), epoch=0)
    assert os.path.exists(path)
    assert ckpt.restore_checkpoint(path)["opt_state"] == {}
