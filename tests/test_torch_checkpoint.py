"""The port's checkpoint files against the JAX package's, on the CPU.

The codec (train/msgpack.py) against ``flax.serialization`` byte for
byte; checkpoint paths against the JAX ``save_checkpoint``; files moving
both ways (a JAX-written file served by the port's ``--serve --restore``
gives the JAX map within test_torch_fullscene's tolerance, rtol 2e-4 /
atol 2e-5; a port-written file restores in JAX to equal leaves); the
Trainer's best / final files; and resumable state, the twin of
tests/test_resume.py (4 unbroken epochs against 2 + save + restore into a
trainer of another seed + 2, losses within rtol 1e-5, the states equal).
"""

import datetime as real_datetime
import io
import json
import os
import types

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from vit_cnn_tpu.infer import fullscene as jax_fs
from vit_cnn_tpu.models.mm_mamba import MultimodalityMamba as JaxFlagship
from vit_cnn_tpu.train import checkpoint as jax_ckpt
from vit_cnn_tpu_torch.cli import build_parser, run_serve
from vit_cnn_tpu_torch.convert import (flax_to_state_dict, seeded_variables,
                                       state_dict_to_flax)
from vit_cnn_tpu_torch.data import get_dataset
from vit_cnn_tpu_torch.models.mm_mamba import MultimodalityMamba
from vit_cnn_tpu_torch.models.registry import get_model
from vit_cnn_tpu_torch.nn.layers import init_parameters
from vit_cnn_tpu_torch.pipeline.patches import AugmentConfig, PatchPipeline
from vit_cnn_tpu_torch.train import checkpoint as ckpt
from vit_cnn_tpu_torch.train import msgpack
from vit_cnn_tpu_torch.train.loop import Trainer

RTOL, ATOL = 2e-4, 2e-5           # test_torch_fullscene's map tolerance
P, BANDS, K = 9, 20, 5
SCENE = {"VCT_SYN_H": "14", "VCT_SYN_W": "16", "VCT_SYN_BANDS": str(BANDS),
         "VCT_SYN_CLASSES": str(K)}
FROZEN = real_datetime.datetime(2026, 3, 4, 5, 6, 7)


@pytest.fixture(scope="module")
def flagship():
    """The flagship at registry width (dim 32), 20 + 1 bands, 5 classes:
    the JAX module, seeded flax variables, and the port's model."""
    jm = JaxFlagship(img_size=P, in_channels1=BANDS, in_channels2=1,
                     dim_embedding=32, n_classes=K)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": key, "dropout": key}, jnp.zeros((2, P, P, BANDS)),
        jnp.zeros((2, P, P, 1)), train=False))
    tree = seeded_variables(flax.core.unfreeze(shapes), seed=0)
    tm = MultimodalityMamba(P, BANDS, 1, 32, K)
    tm.load_state_dict(flax_to_state_dict(tree, tm))
    return jm, tree, tm


@pytest.fixture
def frozen_time(monkeypatch):
    fake = types.SimpleNamespace(datetime=types.SimpleNamespace(
        now=lambda: FROZEN))
    monkeypatch.setattr(jax_ckpt, "datetime", fake)
    monkeypatch.setattr(ckpt, "datetime", fake)


def _leaves_equal(got, want):
    assert type(got) is dict and set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _leaves_equal(got[k], want[k])
        else:
            g, w = got[k], np.asarray(want[k])
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w)


def _mixed_tree():
    rng = np.random.RandomState(1)
    b16 = np.asarray(rng.randn(3, 5), jnp.bfloat16)
    return {"params": {"w": rng.randn(4, 6).astype(np.float32),
                       "half": b16, "big": rng.randn(40000).astype(
                           np.float32)},
            "step": np.int32(17),
            "history": [1, -3, 2.5, [np.int64(9), "x" * 40, None, True],
                        b"\x00" * 300, np.zeros(0, np.float32)],
            "empty": {}}


def test_encoder_gives_flax_bytes_for_the_flagship(flagship):
    _, tree, _ = flagship
    assert msgpack.packb(tree) == serialization.to_bytes(tree)


def test_encoder_gives_flax_bytes_for_bf16_scalars_and_lists():
    tree = _mixed_tree()
    want = serialization.to_bytes(tree)
    assert msgpack.packb(tree) == want
    # the same leaves as torch tensors: bfloat16 through its uint16 view
    as_torch = dict(tree, params={
        k: torch.from_numpy(np.asarray(v).view(np.uint16).copy()).view(
            torch.bfloat16) if v.dtype == jnp.bfloat16 else
        torch.from_numpy(v) for k, v in tree["params"].items()})
    assert msgpack.packb(as_torch) == want


def test_decoder_reads_flax_bytes(flagship):
    _, tree, _ = flagship
    _leaves_equal(msgpack.unpackb(serialization.to_bytes(tree)), tree)
    mixed = _mixed_tree()
    got = msgpack.unpackb(serialization.to_bytes(mixed))
    want = serialization.msgpack_restore(serialization.to_bytes(mixed))
    half = got["params"].pop("half")
    assert half.dtype == torch.bfloat16 and tuple(half.shape) == (3, 5)
    np.testing.assert_array_equal(
        half.view(torch.uint16).numpy(),
        np.asarray(want["params"].pop("half")).view(np.uint16))
    _leaves_equal(got["params"], want["params"])
    assert type(got["step"]) is np.int32 and got["step"] == 17
    hist, want_hist = got["history"], want["history"]
    assert list(hist) == ["0", "1", "2", "3", "4", "5"]
    assert hist["3"] == want_hist["3"] and hist["4"] == want_hist["4"]
    assert hist["5"].dtype == np.float32 and hist["5"].shape == (0,)
    assert got["empty"] == {}


def test_codec_refuses_what_flax_would_chunk_or_not_write():
    chunked = serialization.msgpack_serialize(
        {"a": {"__msgpack_chunked_array__": True, "shape": {"0": 1},
               "chunks": {"0": np.zeros(1, np.float32)}}})
    with pytest.raises(ValueError, match="chunked"):
        msgpack.unpackb(chunked)
    with pytest.raises(ValueError, match="extension type 2"):
        msgpack.unpackb(serialization.to_bytes({"c": 1 + 2j}))
    with pytest.raises(TypeError, match="not a str"):
        msgpack.packb({1: np.zeros(2)})
    with pytest.raises(TypeError, match="cannot serialise"):
        msgpack.packb({"s": {1, 2}})


def test_checkpoint_path_is_the_jax_path(tmp_path, frozen_time, flagship):
    _, tree, _ = flagship
    args = (str(tmp_path), "multimodalitymamba", "Houston2013", "train",
            "best_epoch", "Multimodality_Mamba", 3, 12, 97.123)
    want = jax_ckpt.save_checkpoint(tree, *args)
    with open(want, "rb") as f:
        jax_bytes = f.read()
    got = ckpt.save_checkpoint(tree, *args)
    assert got == want
    assert os.path.basename(got) == \
        "2026_03_04_05_06_07Multimodality_Mamba_run3_epoch12_97.12.msgpack"
    with open(got, "rb") as f:
        assert f.read() == jax_bytes


def test_jax_file_serves_the_jax_map(tmp_path, monkeypatch, flagship):
    """A checkpoint the JAX package wrote, served by the port's
    ``--serve --restore`` on the CPU, gives the JAX map."""
    jm, tree, _ = flagship
    for k, v in SCENE.items():
        monkeypatch.setenv(k, v)
    path = jax_ckpt.save_checkpoint(tree, str(tmp_path), "multimodalitymamba",
                                    "Synthetic")
    img1, img2 = get_dataset("Synthetic", str(tmp_path))[:2]
    want = jax_fs.full_scene_probabilities(
        jm, tree, img1, img2, {"patch_size": P, "n_classes": K}, chunk=32)
    args = build_parser().parse_args([
        "--dataset", "Synthetic", "--folder", str(tmp_path), "--device",
        "cpu", "--serve", "--restore", path, "--infer_chunk", "32"])
    out = str(tmp_path / "probs.npy")
    stream = io.StringIO()
    served = run_serve(args, io.StringIO(json.dumps({"out": out}) + "\n"),
                       stream)
    assert served == 1 and json.loads(stream.getvalue())["ok"]
    np.testing.assert_allclose(np.load(out), want, rtol=RTOL, atol=ATOL)


def test_port_file_restores_in_jax(tmp_path, flagship):
    _, tree, tm = flagship
    path = ckpt.save_checkpoint(state_dict_to_flax(tm), str(tmp_path),
                                "multimodalitymamba", "Synthetic")
    target = jax.tree_util.tree_map(np.zeros_like, tree)
    _leaves_equal(jax_ckpt.restore_checkpoint(path, target), tree)
    # and back into the port, strict both ways
    state = ckpt.restore_state_dict(path, tm)
    for k, v in tm.state_dict().items():
        torch.testing.assert_close(state[k], v, rtol=0, atol=0)


def test_restore_is_strict_both_ways(tmp_path, flagship):
    _, tree, tm = flagship
    extra = dict(tree, params=dict(tree["params"], stray={"bias": np.zeros(
        3, np.float32)}))
    missing = dict(tree, batch_stats={})
    for bad, match in ((extra, "no module"), (missing, "left unset")):
        path = str(tmp_path / "bad.msgpack")
        with open(path, "wb") as f:
            f.write(serialization.to_bytes(bad))
        with pytest.raises(KeyError, match=match):
            ckpt.restore_state_dict(path, tm)


# --------------------------------------------------------------------------
# the Trainer's files and resumable state
# --------------------------------------------------------------------------

@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread. The CPU's float32 train step is bitwise
    repeatable on one thread only: on 4 threads two unbroken 2-epoch runs
    of the flagship on this file's 14 x 16 scene (3 batches of 16 an
    epoch) part by 4e-3 in a weight (the flagship's ill-conditioned
    gradients amplify a reduction's rounding); on 1 thread they are
    equal. One thread also keeps the steps from stalling when the suite's
    workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _trainer(tmp_path, monkeypatch, seed=0, epochs=4, val=False):
    """The flagship on 2 rows of window centers (14 labelled, one padded
    batch of 16 an epoch), flip on."""
    for k, v in SCENE.items():
        monkeypatch.setenv(k, v)
    img1, img2, gt = get_dataset("Synthetic", str(tmp_path))[:3]
    gt = gt.copy()
    gt[P // 2 + 2:] = 0
    model, _, hp = get_model("Multimodality_Mamba", n_classes=K,
                             n_bands=(BANDS, 1), ignored_labels=[0],
                             batch_size=16, epoch=epochs, lr=1e-3)
    init_parameters(model, 0)
    pipe = PatchPipeline(img1, img2, gt, P, [0], K,
                         augment=AugmentConfig(flip=True))
    assert len(pipe) <= 16
    val_pipe = PatchPipeline(img1, img2, gt, P, [0], K) if val else None
    return Trainer(model, hp, pipe, val_pipeline=val_pipe, seed=seed,
                   checkpoint_root=str(tmp_path / "ck"),
                   savename="Multimodality_Mamba")


def test_trainer_writes_best_and_final_files_at_the_jax_paths(
        tmp_path, monkeypatch, frozen_time):
    trainer = _trainer(tmp_path, monkeypatch, epochs=2, val=True)
    metrics = iter((0.4, 0.3))                  # epoch 1 is the best
    trainer.validate = lambda: next(metrics)
    best = trainer.fit(run=1, dataset_name="Synthetic")
    root = str(tmp_path / "ck")
    for path, kind, epoch, metric in (
            (trainer.best_checkpoint, "best_epoch", 1, 0.4),
            (trainer.final_checkpoint, "final_epoch", 2, 0.3)):
        want = jax_ckpt.save_checkpoint(
            {}, str(tmp_path / "jax"), "multimodalitymamba", "Synthetic",
            "train", kind, "Multimodality_Mamba", 1, epoch, metric)
        assert os.path.relpath(path, root) == \
            os.path.relpath(want, str(tmp_path / "jax"))
    restored = ckpt.restore_state_dict(trainer.best_checkpoint,
                                       trainer.model)
    assert set(restored) == set(best)
    for k, v in best.items():
        torch.testing.assert_close(restored[k], v, rtol=0, atol=0)
    final = ckpt.restore_state_dict(trainer.final_checkpoint, trainer.model)
    for k, v in trainer.model.state_dict().items():
        torch.testing.assert_close(final[k], v, rtol=0, atol=0)


def test_resume_reproduces_the_unbroken_run(tmp_path, monkeypatch):
    tr_a = _trainer(tmp_path, monkeypatch)
    tr_a.fit(dataset_name="Synthetic")

    tr_b = _trainer(tmp_path, monkeypatch)
    tr_b.epochs = 2
    tr_b.fit(dataset_name="Synthetic")
    path = tr_b.save_resumable(str(tmp_path / "resume" / "ckpt"), epoch=2)
    assert path.endswith("ckpt.msgpack")
    assert os.path.exists(path + ".meta.json")

    tr_c = _trainer(tmp_path, monkeypatch, seed=123)     # another seed
    start = tr_c.restore_resumable(path)
    assert start == 2
    tr_c.fit(dataset_name="Synthetic", start_epoch=start)
    np.testing.assert_allclose(tr_c.log.losses, tr_a.log.losses[2:],
                               rtol=1e-5)
    for k, v in tr_a.model.state_dict().items():
        torch.testing.assert_close(tr_c.model.state_dict()[k], v,
                                   rtol=1e-5, atol=0)


def test_resume_keeps_the_step_and_the_moments(tmp_path, monkeypatch):
    tr = _trainer(tmp_path, monkeypatch, epochs=1)
    tr.fit(dataset_name="Synthetic")
    assert tr.steps_done > 0
    path = tr.save_resumable(str(tmp_path / "ck2"), epoch=1)
    payload = ckpt.restore_checkpoint(path)
    assert set(payload) == {"params", "batch_stats", "opt_state", "step"}
    assert set(payload["opt_state"]) == {"mu", "nu"}
    assert int(payload["step"]) == tr.steps_done
    tr2 = _trainer(tmp_path, monkeypatch, seed=7, epochs=1)
    tr2.restore_resumable(path)
    assert tr2.steps_done == tr.steps_done
    params2 = dict(tr2.model.named_parameters())
    for name, p in tr.model.named_parameters():
        torch.testing.assert_close(params2[name], p, rtol=0, atol=0)
        s, s2 = tr.optimizer.state[p], tr2.optimizer.state[params2[name]]
        assert float(s2["step"]) == float(s["step"]) == tr.steps_done
        for key in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(s2[key], s[key], rtol=0, atol=0)
    assert torch.equal(tr2.generator.get_state(), tr.generator.get_state())
    assert tr2.np_rng.randint(1 << 30) == tr.np_rng.randint(1 << 30)
