"""Stride > 1 serving and ``--debug_nans`` in the port, against the JAX
package, on the CPU.

* The generic per-origin path at stride 1 gives the band path's map
  (rtol 1e-5 / atol 1e-6: the same windows in other batches).
* The flagship's stride 2 and 3 maps on a 14 x 16 scene, where neither
  stride divides h - p = 5 or w - p = 7 (the last origin row is clamped
  to h - p) and every window fits in one chunk (the padding origins
  share the scatter with origin (0, 0)), equal
  ``vit_cnn_tpu.infer.fullscene.full_scene_probabilities`` on the same
  converted weights within rtol 2e-4 / atol 2e-5, as
  tests/test_torch_fullscene.py holds the band map. Mass lands only on
  window centers.
* The server's ``"stride"`` request key and ``--test_stride`` through the
  CLI.
* A checkpoint with one NaN weight makes both packages' run loops raise
  ``FloatingPointError`` under ``--debug_nans`` (the port's message names
  the module), and neither raises without it; the port's backward and
  parameter checks on their own.
"""

import io
import json

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_cnn_tpu import cli as jax_cli
from vit_cnn_tpu.data import registry as jax_registry
from vit_cnn_tpu.infer import fullscene as jax_fs
from vit_cnn_tpu.models.mm_mamba import MultimodalityMamba as JaxFlagship
from vit_cnn_tpu_torch import cli
from vit_cnn_tpu_torch.convert import (flax_to_state_dict, seeded_variables,
                                       state_dict_to_flax)
from vit_cnn_tpu_torch.infer import fullscene
from vit_cnn_tpu_torch.infer.server import SceneServer
from vit_cnn_tpu_torch.models.mm_mamba import MultimodalityMamba
from vit_cnn_tpu_torch.models.registry import get_model
from vit_cnn_tpu_torch.nn.layers import init_parameters
from vit_cnn_tpu_torch.train import checkpoint as ckpt
from vit_cnn_tpu_torch.utils import nancheck

RTOL, ATOL = 2e-4, 2e-5
P, BANDS, K = 9, 20, 5
H, W = 14, 16             # 6 x 8 window origins; h - p = 5, w - p = 7
CHUNK = 32                # every window of stride 2 (20) or 3 (9) in one
NAN_SCENE = {"VCT_SYN_H": "24", "VCT_SYN_W": "28", "VCT_SYN_BANDS": "20"}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.RandomState(0)
    img1 = rng.rand(H, W, BANDS).astype(np.float32)
    img2 = rng.rand(H, W, 1).astype(np.float32)
    jm = JaxFlagship(img_size=P, in_channels1=BANDS, in_channels2=1,
                     dim_embedding=32, n_classes=K)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": key, "dropout": key}, jnp.zeros((2, P, P, BANDS)),
        jnp.zeros((2, P, P, 1)), train=False))
    tree = seeded_variables(flax.core.unfreeze(shapes), seed=0)
    tm = MultimodalityMamba(P, BANDS, 1, 32, K)
    tm.load_state_dict(flax_to_state_dict(tree, tm))
    return img1, img2, jm, tree, tm.eval()


def test_generic_path_at_stride_1_is_the_band_map(scene):
    img1, img2, _, _, tm = scene
    hp = {"patch_size": P, "n_classes": K}
    band = fullscene.full_scene_probabilities(tm, img1, img2, hp, chunk=16)
    with torch.inference_mode():
        generic = fullscene.per_origin_map(
            tm, torch.from_numpy(img1), torch.from_numpy(img2), P, K, 1, 16)
    np.testing.assert_allclose(generic.numpy(), band, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("step", [2, 3])
def test_strided_map_matches_jax(scene, step):
    img1, img2, jm, tree, tm = scene
    hp = {"patch_size": P, "n_classes": K, "test_stride": step}
    want = jax_fs.full_scene_probabilities(jm, tree, img1, img2, hp,
                                           chunk=CHUNK)
    got = fullscene.full_scene_probabilities(tm, img1, img2, hp, chunk=CHUNK)
    origins = fullscene.sliding_window_origins(H, W, P, step)
    assert len(origins) <= CHUNK
    # the last origin row sits closer to the one before it: 0 2 4 5, 0 3 5
    assert origins[:, 0].max() == H - P and (H - P) % step
    centers = np.zeros((H, W), bool)
    centers[origins[:, 0] + P // 2, origins[:, 1] + P // 2] = True
    assert got.shape == (H, W, K) and got.dtype == np.float32
    assert not got[~centers].any() and np.abs(got[centers]).min() > 0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_origin_0_keeps_its_logits_beside_the_padding(scene):
    """The padding origins of the one chunk are (0, 0) with valid 0: the
    accumulating scatter leaves the real window's logits at its center."""
    img1, img2, _, _, tm = scene
    hp = {"patch_size": P, "n_classes": K, "test_stride": 3}
    got = fullscene.full_scene_probabilities(tm, img1, img2, hp, chunk=CHUNK)
    with torch.inference_mode():
        alone = tm(torch.from_numpy(img1[None, :P, :P]),
                   torch.from_numpy(img2[None, :P, :P]))[0].numpy()
    np.testing.assert_allclose(got[P // 2, P // 2], alone, rtol=1e-5,
                               atol=1e-6)


def test_server_takes_the_stride_key(scene, tmp_path):
    img1, img2, _, _, tm = scene
    hp = {"patch_size": P, "n_classes": K}
    server = SceneServer(tm, hp, chunk=CHUNK)
    reqs = [{"stride": 3, "out": str(tmp_path / "s3.npy")},
            {"out": str(tmp_path / "s1.npy")}]
    out = io.StringIO()
    served = server.loop(io.StringIO("\n".join(map(json.dumps, reqs))),
                         out, img1, img2)
    resps = [json.loads(l) for l in out.getvalue().splitlines()]
    assert served == 2 and all(r["ok"] for r in resps)
    np.testing.assert_array_equal(
        np.load(tmp_path / "s3.npy"), fullscene.full_scene_probabilities(
            tm, img1, img2, dict(hp, test_stride=3), chunk=CHUNK))
    np.testing.assert_array_equal(
        np.load(tmp_path / "s1.npy"), fullscene.full_scene_probabilities(
            tm, img1, img2, hp, chunk=CHUNK))


def test_cli_serves_at_a_stride(tmp_path, monkeypatch):
    for k, v in (("H", "14"), ("W", "16"), ("BANDS", "20")):
        monkeypatch.setenv("VCT_SYN_" + k, v)
    args = cli.build_parser().parse_args([
        "--dataset", "Synthetic", "--folder", str(tmp_path), "--device",
        "cpu", "--bf16", "--test_stride", "3", "--infer_chunk", "64",
        "--serve"])
    out = io.StringIO()
    served = cli.run_serve(args, io.StringIO(
        json.dumps({"out": str(tmp_path / "m.npy")}) + "\n"), out)
    (resp,) = [json.loads(l) for l in out.getvalue().splitlines()]
    assert served == 1 and resp["ok"]
    probs = np.load(tmp_path / "m.npy")
    # stride 3: origin rows 0, 3, 5 (6 clamped to h - p) x columns 0, 3, 6
    assert np.isfinite(probs).all() and (np.abs(probs).sum(-1) > 0).sum() \
        == 3 * 3


# --------------------------------------------------------------------------
# --debug_nans
# --------------------------------------------------------------------------

@pytest.fixture
def nan_file(tmp_path, monkeypatch):
    """EndNet's checkpoint with one NaN weight, in the format both
    packages restore, on a 24 x 28 Synthetic scene."""
    # the JAX registry fixes Synthetic's label values when it is imported
    classes = len(jax_registry.DATASETS["Synthetic"].label_values)
    for k, v in dict(NAN_SCENE, VCT_SYN_CLASSES=str(classes)).items():
        monkeypatch.setenv(k, v)
    monkeypatch.chdir(tmp_path)
    model = get_model("EndNet", n_classes=classes, n_bands=(20, 1))[0]
    init_parameters(model, 0)
    state = model.state_dict()
    state["encoder_a.Dense_0.weight"][0, 0] = float("nan")
    return ckpt.save_checkpoint(state_dict_to_flax(model, state),
                                str(tmp_path), "endnet", "Synthetic")


def _run_argv(path, flag):
    return (["--dataset", "Synthetic", "--folder", ".", "--model", "EndNet",
             "--runs", "1", "--epoch", "1", "--batch_size", "32",
             "--training_sample", "25", "--infer_chunk", "128",
             "--log_every", "0", "--restore", path]
            + (["--debug_nans"] if flag else []))


@pytest.mark.parametrize("flag", [True, False])
def test_port_debug_nans_stops_a_poisoned_run(nan_file, flag):
    args = cli.build_parser().parse_args(_run_argv(nan_file, flag)
                                         + ["--device", "cpu"])
    if flag:
        with pytest.raises(FloatingPointError,
                           match=r"output of encoder_a\.Dense_0 \(Dense\)"):
            cli.run_experiments(args)
    else:
        (result,) = cli.run_experiments(args)
        assert np.isnan(result["losses"]).all()


@pytest.mark.parametrize("flag", [True, False])
def test_jax_debug_nans_stops_a_poisoned_run(nan_file, flag):
    args = jax_cli.build_parser().parse_args(_run_argv(nan_file, flag)
                                             + ["--no_mesh"])
    try:
        if flag:
            with pytest.raises(FloatingPointError):
                jax_cli.run_experiments(args)
        else:
            assert len(jax_cli.run_experiments(args)) == 1
    finally:
        jax.config.update("jax_debug_nans", False)


def test_nancheck_backward_and_parameters():
    """A NaN made only in the backward (sqrt's gradient behind a where)
    raises; an infinity in a forward does not (jax_debug_infs is another
    flag); a NaN parameter is named."""
    x = torch.tensor([-1.0, 4.0], requires_grad=True)
    y = torch.where(x > 0, torch.sqrt(x), torch.zeros_like(x)).sum()
    assert torch.isfinite(y)
    with pytest.warns(UserWarning):          # anomaly mode announces itself
        with pytest.raises(FloatingPointError, match="SqrtBackward"):
            nancheck.backward(y)
    lin = torch.nn.Sequential(torch.nn.Linear(2, 2))
    handles = nancheck.watch(lin)
    lin(torch.tensor([[float("inf"), 0.0]]))
    nancheck.check_parameters(lin)
    with torch.no_grad():
        lin[0].bias[1] = float("nan")
    with pytest.raises(FloatingPointError, match=r"output of 0 \(Linear\)"):
        lin(torch.zeros(1, 2))
    with pytest.raises(FloatingPointError, match="parameter 0.bias"):
        nancheck.check_parameters(lin)
    for h in handles:
        h.remove()
    lin(torch.zeros(1, 2))
