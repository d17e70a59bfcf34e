"""The port's full-scene serving path against the JAX package: the
stride-1 band map of the flagship on a small scene, the window helpers,
the ``--serve`` JSON-line protocol on the CPU, and the port's freedom
from jax.

Tolerance of the map: the JAX suite's float32 op tolerance, rtol 2e-4 /
atol 2e-5 (the same flagship comparison as test_torch_mm_mamba, summed
into the map once per window).
"""

import io
import json
import os
import subprocess
import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_cnn_tpu.infer import fullscene as jax_fs
from vit_cnn_tpu.models.mm_mamba import MultimodalityMamba as JaxFlagship
from vit_cnn_tpu_torch.cli import build_parser, run_serve
from vit_cnn_tpu_torch.convert import flax_to_state_dict, seeded_variables
from vit_cnn_tpu_torch.infer import fullscene
from vit_cnn_tpu_torch.infer.server import SceneServer
from vit_cnn_tpu_torch.models.mm_mamba import MultimodalityMamba

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 2e-4, 2e-5
P, BANDS, K = 9, 20, 5
H, W = 14, 16             # 6 x 8 window origins
CHUNK = 32                # 4 origin rows per band: 2 bands, 2 padding rows


@pytest.fixture(scope="module")
def scene():
    rng = np.random.RandomState(0)
    img1 = rng.rand(H, W, BANDS).astype(np.float32)
    img2 = rng.rand(H, W, 1).astype(np.float32)
    gt = rng.randint(0, K, (H, W)).astype(np.int64)
    jm = JaxFlagship(img_size=P, in_channels1=BANDS, in_channels2=1,
                     dim_embedding=32, n_classes=K)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": key, "dropout": key}, jnp.zeros((2, P, P, BANDS)),
        jnp.zeros((2, P, P, 1)), train=False))
    tree = seeded_variables(flax.core.unfreeze(shapes), seed=0)
    tm = MultimodalityMamba(P, BANDS, 1, 32, K)
    tm.load_state_dict(flax_to_state_dict(tree, tm))
    return img1, img2, gt, jm, tree, tm.eval()


def test_band_map_matches_jax(scene):
    img1, img2, _, jm, tree, tm = scene
    hp = {"patch_size": P, "n_classes": K}
    want = jax_fs.full_scene_probabilities(jm, tree, img1, img2, hp,
                                           chunk=CHUNK)
    got = fullscene.full_scene_probabilities(tm, img1, img2, hp,
                                             chunk=CHUNK)
    assert got.shape == (H, W, K) and got.dtype == np.float32
    # border pixels get no mass; every window center gets its logits once
    assert not got[:P // 2].any() and not got[:, W - P // 2:].any()
    assert np.abs(got[P // 2:H - P // 2, P // 2:W - P // 2]).min() > 0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("chunk", [8, 24, 1000])
def test_band_count_does_not_change_the_map(scene, chunk):
    """One origin row per band, 3 rows (no padding) and the whole scene in
    one band all give the map of the 2-band, padded run."""
    img1, img2, _, _, _, tm = scene
    hp = {"patch_size": P, "n_classes": K}
    want = fullscene.full_scene_probabilities(tm, img1, img2, hp,
                                              chunk=CHUNK)
    got = fullscene.full_scene_probabilities(tm, img1, img2, hp, chunk=chunk)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("h,w,p,step", [(14, 16, 9, 1), (30, 41, 7, 3),
                                        (12, 12, 5, 4)])
def test_window_origins_match_jax(h, w, p, step):
    np.testing.assert_array_equal(
        fullscene.sliding_window_origins(h, w, p, step),
        jax_fs.sliding_window_origins(h, w, p, step))


def test_band_patches_match_jax():
    band = np.random.RandomState(1).rand(4 + P - 1, W, 3).astype(np.float32)
    want = jax_fs.band_patches(jnp.asarray(band), 4, P)
    got = fullscene.band_patches(torch.from_numpy(band), 4, P)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_server_answers_out_pred_gt_and_keeps_the_scene(scene, tmp_path):
    img1, img2, gt, _, _, tm = scene
    hp = {"patch_size": P, "n_classes": K}
    server = SceneServer(tm, hp, ignored_labels=[0], chunk=CHUNK)
    np.save(tmp_path / "gt.npy", gt)
    reqs = [{"out": str(tmp_path / "p.npy")}, {},
            {"pred": str(tmp_path / "l.npy"), "gt": str(tmp_path / "gt.npy")},
            {"stride": 2}, {"cmd": "quit"}, {}]
    out = io.StringIO()
    served = server.loop(io.StringIO("\n".join(map(json.dumps, reqs))
                                     + "\n{bad json\n"), out, img1, img2)
    resps = [json.loads(l) for l in out.getvalue().splitlines()]
    assert served == 3 and len(resps) == 4
    assert all(r["ok"] for r in resps[:3])
    assert resps[3]["ok"] is False and "NotImplementedError" in \
        resps[3]["error"]
    probs = np.load(tmp_path / "p.npy")
    assert list(probs.shape) == resps[0]["shape"] == [H, W, K]
    np.testing.assert_array_equal(np.load(tmp_path / "l.npy"),
                                  probs.argmax(-1))
    assert 0.0 <= resps[2]["OA"] <= 100.0 and np.isfinite(resps[2]["Kappa"])
    assert server.cache.uploads == 2       # hsi + lidar, once


def test_cli_serves_on_the_cpu(tmp_path, monkeypatch):
    for k, v in (("H", "14"), ("W", "16"), ("BANDS", "20")):
        monkeypatch.setenv("VCT_SYN_" + k, v)
    args = build_parser().parse_args([
        "--dataset", "Synthetic", "--folder", str(tmp_path),
        "--device", "cpu", "--bf16", "--infer_chunk", "64", "--serve"])
    out = io.StringIO()
    served = run_serve(args, io.StringIO('{}\n{"cmd": "quit"}\n'), out)
    (resp,) = [json.loads(l) for l in out.getvalue().splitlines()]
    assert served == 1 and resp["ok"] and resp["shape"][:2] == [14, 16]


def test_cli_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    args = build_parser().parse_args(["--dataset", "Synthetic", "--serve"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_serve(args, io.StringIO(""), io.StringIO())


def test_port_imports_no_jax():
    """Nor scikit-learn, which the GPU host lacks (the training split is
    the port's own)."""
    code = ("import sys, vit_cnn_tpu_torch, vit_cnn_tpu_torch.cli, "
            "vit_cnn_tpu_torch.convert, vit_cnn_tpu_torch.__main__, "
            "vit_cnn_tpu_torch.train, vit_cnn_tpu_torch.train.loop, "
            "vit_cnn_tpu_torch.pipeline, vit_cnn_tpu_torch.pipeline.patches, "
            "vit_cnn_tpu_torch.data.sampling, "
            "vit_cnn_tpu_torch.tools.profile_train, "
            "vit_cnn_tpu_torch.tools.train_conditioning; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'sklearn')))")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
