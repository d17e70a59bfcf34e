"""Training the CNN zoo in the port against the JAX package, on the CPU.

* The CPU's oneDNN faults behind ``nn.layers.Conv``'s explicit padding:
  the bf16 weight gradient of a stride-1 3-D conv padded on its depth,
  kernel deeper than the input, 16 input channels, and the float32 one
  of a strided padded 3-D conv. ``Conv``'s padded path gets both right
  on every call; whether the plain ``F.conv3d`` reproduces the bf16
  fault (garbage or NaN in torch 2.13.0) depends on the heap, so that is
  reported and not held.
* One float64 train step of each CNN model at its registry width and
  patch size over 12 + 1 bands (13 + 1 for MFT: its HetConv's other group
  count), port against ``jax.grad`` under ``enable_x64``: the loss (the
  registry's: ``cross_fusion``, ``endnet`` or the cross-entropy), every
  gradient and the updated BatchNorm statistics within 1e-7 (per tensor
  in norm, plus 1e-12 of the largest gradient norm for gradients that
  vanish), a padded last row (valid 0) and a class of weight 0. MFT's and
  HCTnet's dropout masks are drawn once by the port (``noise.Recorder``)
  and handed to JAX (tests/test_torch_zoo_train.py's ``_Shared``).
* ``cross_fusion_loss``, ``endnet_loss`` and ``focal_loss`` against the
  JAX functions; ``LOSSES`` has JAX's keys.
* The CLI trains Cross_fusion_CNN, EndNet, MFT and HCTnet (on the PCA of
  the HSI) for one epoch; HCTnet's best file serves back through
  ``--serve --restore`` with the run's OA / AA / Kappa and restores into
  a second run.
"""

import io
import json
import os
import warnings

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_zoo_train import _Shared

from vit_cnn_tpu.models import registry as jax_registry
from vit_cnn_tpu.train import losses as jax_losses
from vit_cnn_tpu_torch import cli
from vit_cnn_tpu_torch.convert import flax_to_state_dict, seeded_variables
from vit_cnn_tpu_torch.models import registry
from vit_cnn_tpu_torch.nn import noise
from vit_cnn_tpu_torch.nn.layers import Conv
from vit_cnn_tpu_torch.train import losses

TOL64, FLOOR64 = 1e-7, 1e-12
K, BATCH = 5, 4
CNN_ZOO = ("EndNet", "Early_fusion_CNN", "Middle_fusion_CNN",
           "Late_fusion_CNN", "Cross_fusion_CNN", "S2ENet", "FusAtNet",
           "MFT", "HCTnet")
BANDS = {"MFT": 13}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------
# the oneDNN fault
# --------------------------------------------------------------------------

def test_bf16_padded_conv3d_weight_gradient_is_right_through_conv():
    """The two cases behind ``Conv``'s explicit padding, 20 weight
    gradients each through ``Conv`` against the float64 one (limit 2e-2
    of its largest entry, a few bf16 steps):

    * bf16 at stride 1: x (1, 16, 2, 1, 1), w (1, 16, 3, 1, 1), padding
      (1, 0, 0);
    * float32 strided: x (2, 1, 8, 1, 1), w (16, 1, 11, 1, 1), stride
      (3, 1, 1), padding (5, 0, 0).

    ``Conv`` pads explicitly on the CPU and must pass all 40. Whether the
    plain ``F.conv3d`` reproduces the library's fault depends on the
    state of the heap (every call in a busy worker, none in a fresh
    process), so its count is reported, not held: a warning when it was
    right in all 20 calls of a case."""
    g = torch.Generator().manual_seed(0)
    cases = [(torch.bfloat16, (1, 16, 2, 1, 1), (1, 16, 3, 1, 1), 1,
              (1, 0, 0)),
             (torch.float32, (2, 1, 8, 1, 1), (16, 1, 11, 1, 1), (3, 1, 1),
              (5, 0, 0))]
    for dtype, xs, ws, stride, padding in cases:
        x = torch.randn(xs, generator=g).to(dtype)
        w = torch.randn(ws, generator=g).to(dtype)
        w64 = w.double().requires_grad_(True)
        y64 = F.conv3d(x.double(), w64, None, stride, padding)
        gy = torch.randn(y64.shape, generator=g).to(dtype)
        (ref,) = torch.autograd.grad(y64, w64, gy.double())
        conv = Conv(ws[1], ws[0], ws[2:], strides=stride, padding=padding,
                    use_bias=False)

        def wrong(fn):
            wr = w.clone().requires_grad_(True)
            (gw,) = torch.autograd.grad(fn(wr), wr, gy)
            err = float((gw.double() - ref).abs().max())
            return not err <= 2e-2 * float(ref.abs().max())

        def through_conv(wr):
            y = torch.func.functional_call(conv, {"weight": wr},
                                           (x.movedim(1, -1),))
            return y.movedim(-1, 1)

        ported = sum(wrong(through_conv) for _ in range(20))
        assert ported == 0, (dtype, ported)
        if dtype == torch.bfloat16:
            # the strided case's fault is heap corruption that may abort
            # the process: only the bf16 one runs the plain conv
            plain = sum(wrong(lambda wr: F.conv3d(x, wr, None, stride,
                                                  padding))
                        for _ in range(20))
            if plain == 0:
                warnings.warn("torch's CPU conv3d gave the right bf16 weight "
                              "gradient in 20 of 20 calls here: if it does "
                              "so in every run, drop the bf16 case of "
                              "nn.layers.Conv's explicit padding")


# --------------------------------------------------------------------------
# one train step against jax.grad
# --------------------------------------------------------------------------

def _hp(name):
    n1 = BANDS.get(name, 12)
    hp = dict(n_classes=K, n_bands=(n1, 1))
    if name == "HCTnet":
        hp["pca_components"] = n1        # built for the bands it is given
    return hp


@pytest.fixture(scope="module", params=CNN_ZOO)
def step64(request):
    name = request.param
    hp = _hp(name)
    jm, _, jhp = jax_registry.get_model(name, **hp)
    p, n1 = jhp["patch_size"], hp["n_bands"][0]
    rng = np.random.RandomState(1)
    hsi = rng.rand(BATCH, p, p, n1)
    lidar = rng.rand(BATCH, p, p, 1)
    labels = np.array([1, 3, 0, 4])
    weights = np.array([0, 1, 1, 0.5, 2])
    valid = np.array([1, 1, 1, 0.0])
    key = jax.random.PRNGKey(0)
    init = flax.core.unfreeze(jax.eval_shape(lambda: jm.init(
        {"params": key, "dropout": key}, jnp.asarray(hsi, jnp.float32),
        jnp.asarray(lidar, jnp.float32), train=False)))
    tree = seeded_variables(init, seed=0)
    loss_name = jhp["loss"]

    tm = registry.get_model(name, **hp)[0]
    tm.load_state_dict(flax_to_state_dict(tree, tm))
    tm.double().train()
    rec = noise.Recorder(torch.Generator().manual_seed(7))
    with noise.drawing(rec):
        out = tm(torch.from_numpy(hsi), torch.from_numpy(lidar))
    loss = losses.LOSSES[loss_name](out, torch.from_numpy(labels),
                                    torch.from_numpy(weights),
                                    torch.from_numpy(valid))
    loss.backward()

    with jax.enable_x64(True):
        variables = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), tree)
        shared = _Shared(rec.draws)

        def loss_fn(params):
            out, upd = jm.apply(dict(variables, params=params),
                                jnp.asarray(hsi), jnp.asarray(lidar),
                                train=True, mutable=["batch_stats"],
                                rngs={"dropout": key})
            return jax_losses.LOSSES[loss_name](
                out, jnp.asarray(labels), jnp.asarray(weights),
                jnp.asarray(valid)), upd

        with fnn.intercept_methods(shared.interceptor):
            (want_loss, upd), grads = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True))(variables["params"])
        assert shared.taken == len(rec.draws)
        as64 = lambda t: jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), jax.device_get(t))
        want = flax_to_state_dict(
            {"params": as64(grads), "batch_stats": as64(upd["batch_stats"])},
            registry.get_model(name, **hp)[0].double())
    return name, float(loss.detach()), float(want_loss), tm, want, rec.draws


def test_float64_step_matches_jax(step64):
    name, loss, want_loss, tm, want, draws = step64
    assert loss == pytest.approx(want_loss, rel=TOL64)
    stats = {k: v for k, v in tm.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    assert stats and set(stats) == {k for k in want if k.endswith(
        ("running_mean", "running_var"))}
    for k, v in stats.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=TOL64,
                                   atol=0, err_msg=k)
    params = dict(tm.named_parameters())
    floor = FLOOR64 * max(float(want[k].norm()) for k in params)
    for k, p in params.items():
        err = float((p.grad - want[k]).norm())
        assert err <= TOL64 * float(want[k].norm()) + floor, (
            k, err, float(want[k].norm()))
    # MFT's and HCTnet's dropout drew its masks; the CNNs have none
    assert (len(draws) > 0) == (name in ("MFT", "HCTnet"))


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

def _loss_inputs(n_out, seed=4):
    rng = np.random.RandomState(seed)
    outs = tuple(rng.randn(6, K).astype(np.float32) for _ in range(n_out))
    labels = np.array([0, 1, 2, 3, 4, 1])
    weights = np.array([1, 0.5, 2, 1, 0], np.float32)
    valid = np.array([1, 1, 1, 1, 0, 0], np.float32)
    return outs, labels, weights, valid


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["cross_fusion", "endnet"])
def test_multi_output_losses_match_jax(name, masked):
    """Cross_fusion_CNN's three logit sets (the sum of CE and two MSEs,
    not divided by 3) and EndNet's (logits, recon1, recon2, input1,
    input2), with and without a padded ``valid`` (the masked mean over
    valid rows x features)."""
    rng = np.random.RandomState(5)
    (logits,), labels, weights, valid = _loss_inputs(1)
    if name == "cross_fusion":
        out = (logits,) + tuple(rng.randn(6, K).astype(np.float32)
                                for _ in range(2))
    else:
        out = (logits,) + tuple(rng.rand(6, n).astype(np.float32)
                                for n in (7, 1, 7, 1))
    v = valid if masked else None
    got = losses.LOSSES[name](
        tuple(map(torch.from_numpy, out)), torch.from_numpy(labels),
        torch.from_numpy(weights), None if v is None else torch.from_numpy(v))
    want = jax_losses.LOSSES[name](
        tuple(map(jnp.asarray, out)), jnp.asarray(labels),
        jnp.asarray(weights), None if v is None else jnp.asarray(v))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("alpha", [False, True])
@pytest.mark.parametrize("gamma", [0.0, 2.0])
def test_focal_loss_matches_jax(gamma, alpha, masked):
    (logits,), labels, weights, valid = _loss_inputs(1, seed=6)
    a = weights if alpha else None
    v = valid if masked else None
    for size_average in (True, False):
        got = losses.focal_loss(
            torch.from_numpy(logits), torch.from_numpy(labels), gamma,
            None if a is None else torch.from_numpy(a), size_average,
            None if v is None else torch.from_numpy(v))
        want = jax_losses.focal_loss(
            jnp.asarray(logits), jnp.asarray(labels), gamma,
            None if a is None else jnp.asarray(a), size_average,
            None if v is None else jnp.asarray(v))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_losses_have_the_jax_keys():
    assert sorted(losses.LOSSES) == sorted(jax_losses.LOSSES)


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

SCENE = {"VCT_SYN_H": "16", "VCT_SYN_W": "18", "VCT_SYN_BANDS": "32",
         "VCT_SYN_CLASSES": "4"}


@pytest.fixture
def scene_env(monkeypatch, tmp_path):
    for k, v in SCENE.items():
        monkeypatch.setenv(k, v)
    monkeypatch.chdir(tmp_path)               # ./checkpoints


def _args(tmp_path, model, *extra):
    return cli.build_parser().parse_args([
        "--dataset", "Synthetic", "--folder", str(tmp_path), "--device",
        "cpu", "--model", model, "--batch_size", "32", "--training_sample",
        "30", "--infer_chunk", "64", "--log_every", "0", "--out_dir",
        str(tmp_path / "results"), "--runs", "1", "--epoch", "1", *extra])


@pytest.mark.parametrize("model", ["Cross_fusion_CNN", "EndNet", "MFT"])
def test_cli_trains_a_cnn_model_on_the_cpu(tmp_path, scene_env, model):
    """One bf16 epoch through run_train with the registry's loss: finite
    losses, a score, the best and final files."""
    result = cli.run_train(_args(tmp_path, model, "--bf16",
                                 "--flip_augmentation"))
    assert result["epochs"] == 1 and np.isfinite(result["losses"]).all()
    assert 0.0 <= result["OA"] <= 100.0
    for key in ("best_checkpoint", "final_checkpoint"):
        assert os.path.exists(result[key])


def test_cli_trains_hctnet_on_the_pca_and_serves_its_best_file(
        tmp_path, scene_env, monkeypatch):
    """HCTnet trains on the 30 whitened PCA components of the 32-band HSI
    (the registry's applyPCA): the pipeline holds the reduced scene. Its
    best file serves back through --serve --restore with the run's OA /
    AA / Kappa exactly, and --restore starts a second run from it."""
    seen = {}
    real_pipeline = cli.PatchPipeline

    def pipeline(img1, *args, **kwargs):
        seen.setdefault("bands", img1.shape[-1])
        return real_pipeline(img1, *args, **kwargs)

    real_split = cli._load_gt_pair

    def split(*args, **kwargs):
        seen["split"] = real_split(*args, **kwargs)
        return seen["split"]

    monkeypatch.setattr(cli, "PatchPipeline", pipeline)
    monkeypatch.setattr(cli, "_load_gt_pair", split)
    result = cli.run_train(_args(tmp_path, "HCTnet"))
    assert seen["bands"] == 30 and np.isfinite(result["losses"]).all()
    np.save("test_gt.npy", seen["split"][1])
    args = cli.build_parser().parse_args([
        "--dataset", "Synthetic", "--folder", str(tmp_path), "--device",
        "cpu", "--model", "HCTnet", "--serve", "--infer_chunk", "64",
        "--restore", result["best_checkpoint"]])
    out = io.StringIO()
    cli.run_serve(args, io.StringIO('{"gt": "test_gt.npy"}\n'), out)
    resp = json.loads(out.getvalue())
    assert [resp["OA"], resp["AA"], resp["Kappa"]] == \
        [result["OA"], result["AA"], result["Kappa"]]
    again = cli.run_train(_args(tmp_path, "HCTnet", "--restore",
                                result["best_checkpoint"]))
    assert np.isfinite(again["losses"]).all()
