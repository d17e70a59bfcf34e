"""The port's mesh on the CPU: data parallelism over a torch.distributed
group of two gloo ranks (vit_cnn_tpu_torch.parallel.mesh), held against
world size 1 in the port and against the JAX package's float64 step over
the same global batch.

Three groups are started: one for the Python API (Trainer, full-scene
maps, resumable state, Pretrainer, a failing rank), one for
``run_experiments --n_devices 2`` and one for ``--serve --n_devices 2``.
Every rank runs torch on one thread. The checks run the tasks of
vit_cnn_tpu_torch.tools.mesh_check on both ranks and, with no mesh, in
this process.

Tolerances.
* The float64 step against JAX's float64 step on the same 8 centers:
  loss, updated BatchNorm statistics and every summed gradient within
  1e-7 (relative, per tensor in norm, plus 1e-12 of the largest gradient
  norm), the limit of tests/test_torch_train_step.py. In float64 the
  reduction order vanishes, so a BatchNorm without the global sums, a
  mean for the sum of the gradients or a local loss denominator each
  fails it by far more.
* 2 ranks against 1, float32: step-1 loss within 1e-5 + 1e-4 |L|, the
  3-step trajectory within rtol 5e-3 / atol 1e-4 (the JAX package's
  ``dryrun_multichip`` limits: AdamW moves a weight by ~lr whatever the
  size of a gradient that differs in rounding), the BatchNorm statistics
  after step 1 within the step-1 limit, 1e-5 + 1e-4 |value| (the float32
  fast variance E[x^2] - E[x]^2 keeps only the digits its mean does not
  cancel: 1.1e-5 apart on a running variance of 1.4 here), the
  maps within 1e-5 of max(1, max |map|), resumable state bit for bit,
  MoCo's loss within 1e-5 relative, its queue within 1e-6 and its
  pointer equal, and the served maps within atol 1e-5
  (tests/test_serve.py asks the same of the JAX mesh).
"""

import io
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train_step import jax_flagship, jax_step
from vit_cnn_tpu.cli import build_parser as jax_build_parser
from vit_cnn_tpu_torch import cli
from vit_cnn_tpu_torch.cli import build_parser, main, run_experiments, \
    run_serve
from vit_cnn_tpu_torch.convert import flax_to_state_dict, seeded_state_dict
from vit_cnn_tpu_torch.data import get_dataset
from vit_cnn_tpu_torch.models.moco import DualModalEncoder
from vit_cnn_tpu_torch.models.registry import get_model
from vit_cnn_tpu_torch.parallel import mesh as mesh_lib
from vit_cnn_tpu_torch.parallel import make_mesh
from vit_cnn_tpu_torch.tools import mesh_check as mc

SCENE = {"VCT_SYN_H": "17", "VCT_SYN_W": "21", "VCT_SYN_BANDS": "20",
         "VCT_SYN_CLASSES": "5"}
HP = dict(dataset="Synthetic", n_classes=5, n_bands=(20, 1),
          ignored_labels=[0], batch_size=8, epoch=1)
TOL64, FLOOR64 = 1e-7, 1e-12


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    old = {k: os.environ.get(k) for k in SCENE}
    os.environ.update(SCENE)
    try:
        return get_dataset("Synthetic", str(tmp_path_factory.mktemp("s")))[:3]
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _case(scene, model="Multimodality_Mamba", state=None, dtype="float32",
          **hp):
    hp = dict(HP, **hp)
    if state is None:
        state = seeded_state_dict(get_model(model, **hp)[0], 0)
    return dict(model=model, scene=scene, hp=hp, state=state, dtype=dtype,
                seed=3)


def _stats(state):
    return {k: v for k, v in state.items()
            if k.endswith(("running_mean", "running_var"))}


# --------------------------------------------------------------------------
# the module, without a group
# --------------------------------------------------------------------------

def test_shard_rows_cuts_the_global_batch_in_rank_order():
    x = torch.arange(12).reshape(6, 2)
    parts = [mesh_lib.shard_rows(x, mesh_lib.Mesh(r, 3, "cpu"))
             for r in range(3)]
    assert torch.equal(torch.cat(parts), x)
    assert mesh_lib.shard_rows(x) is x                 # no mesh engaged
    with pytest.raises(ValueError, match="does not split"):
        mesh_lib.shard_rows(x, mesh_lib.Mesh(0, 4, "cpu"))


def test_a_world_of_one_starts_nothing_and_engages_nothing():
    m = make_mesh(1, "cpu")
    assert (m.rank, m.world_size, m.backend) == (0, 1, None)
    assert m.run(lambda mesh, a: a + 1, 1) == 2
    with mesh_lib.engaged(m):
        assert mesh_lib.current() is None and mesh_lib.world_size() == 1
        t = torch.ones(2, requires_grad=True)
        assert mesh_lib.global_sum(t) is t
    assert mesh_lib.visible_devices("cpu") == 1


def test_a_batch_the_ranks_do_not_divide_raises(scene):
    case = _case(scene, batch_size=7)
    with pytest.raises(ValueError, match="does not split over 2 ranks"):
        mc.trainer(mesh_lib.Mesh(0, 2, "cpu"), case)


# --------------------------------------------------------------------------
# the Python API on one group of two ranks
# --------------------------------------------------------------------------

class TestTwoRanks:
    """Every check of this class runs on one group; the last one (a
    failing rank) ends it."""

    @pytest.fixture(scope="class")
    def mesh(self):
        threads = torch.get_num_threads()
        torch.set_num_threads(1)              # the ranks take this
        m = make_mesh(2, "cpu")
        torch.set_num_threads(threads)
        yield m
        if not m._closed:
            m.close()

    def test_float64_step_is_jax_step_over_the_global_batch(self, mesh,
                                                            scene):
        """Batch 8 split 4 + 4, flip off: the loss, the updated statistics
        and the summed gradients of the 2-rank step against JAX's float64
        step on the same 8 patches."""
        jm, tree = jax_flagship(bands=20, lidar=1, n_classes=5)
        net, _, hp = get_model("Multimodality_Mamba", **HP)
        case = _case(scene, state=flax_to_state_dict(tree, net),
                     dtype="float64")
        got = mesh.run(mc.train_steps, case, 1, grads=True)
        img1, img2, gt = scene
        rows, cols = mc.batches(case, 1)[0].T
        win = lambda img: np.stack([img[r - 4:r + 5, c - 4:c + 5]
                                    for r, c in zip(rows, cols)])
        with jax.enable_x64(True):
            loss, want = jax_step(jm, tree, win(img1), win(img2),
                                  gt[rows, cols], hp["weights"],
                                  np.ones(8, np.float32), jnp.float64)
        assert got["losses"][0] == pytest.approx(loss, rel=TOL64)
        stats = _stats(got["state_1"])
        assert len(stats) == 32
        for k, v in stats.items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(),
                                       rtol=TOL64, atol=0, err_msg=k)
        grads = got["grads_1"]
        top = max(float(want[k].norm()) for k in grads)
        for k, g in grads.items():
            err = float((g - want[k]).norm())
            assert err <= TOL64 * float(want[k].norm()) + FLOOR64 * top, (
                k, err)
        assert got["spread"] == 0.0

    @pytest.mark.parametrize("model", ["Multimodality_Mamba", "MHST"])
    def test_float32_trajectory_matches_one_rank(self, mesh, scene, model):
        """3 steps with flip on (MHST: its dropout and Gumbel noise too),
        2 ranks against 1: the dryrun_multichip limits; the replicas stay
        equal bit for bit."""
        case = _case(scene, model, flip_augmentation=True)
        one = mc.train_steps(None, case, 3)
        two = mesh.run(mc.train_steps, case, 3)
        l1, l2 = one["losses"], two["losses"]
        assert np.isfinite(l2).all()
        assert abs(l2[0] - l1[0]) <= 1e-5 + 1e-4 * abs(l1[0])
        np.testing.assert_allclose(l2, l1, rtol=5e-3, atol=1e-4)
        assert two["spread"] == 0.0
        s1, s2 = _stats(one["state_1"]), _stats(two["state_1"])
        assert s1 and s1.keys() == s2.keys()
        for k in s1:
            np.testing.assert_allclose(s2[k].numpy(), s1[k].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=k)

    def test_maps_match_one_rank(self, mesh, scene):
        """The stride-1 band map (bands of 4 origin rows, groups of 8, the
        scene padded from 9 origin rows to 16) and the stride-2 map."""
        case = _case(scene)
        one = mc.maps(None, case, (1, 2), chunk=64)
        two = mesh.run(mc.maps, case, (1, 2), chunk=64)
        for s in (1, 2):
            assert two[s].shape == (17, 21, 5)
            assert np.abs(one[s]).sum() > 0
            limit = 1e-5 * max(1.0, float(np.abs(one[s]).max()))
            np.testing.assert_allclose(two[s], one[s], rtol=0, atol=limit)

    def test_resumable_state_round_trips_exactly(self, mesh, scene,
                                                 tmp_path):
        got = mesh.run(mc.resume, _case(scene, flip_augmentation=True),
                       str(tmp_path))
        assert got["epoch"] == 1 and got["exact"]
        assert np.isfinite(got["next_loss"])
        assert got["next_loss"] == got["next_loss_unbroken"]
        assert sorted(os.listdir(tmp_path)) == [       # rank 0's, once
            "resume.msgpack", "resume.msgpack.meta.json"]

    def test_moco_steps_match_one_rank(self, mesh, scene):
        state = seeded_state_dict(DualModalEncoder(20, 1), 0)
        case = dict(scene=scene, state=state, seed=3, hp=dict(
            patch_size=5, lr=5e-4, epoch=1, batch_size=8, radiation=True,
            mixture=True))
        one = mc.moco_steps(None, case, 2, queue_size=24)
        two = mesh.run(mc.moco_steps, case, 2, queue_size=24)
        np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5)
        assert two["queue_ptr"] == one["queue_ptr"] == 16
        np.testing.assert_allclose(two["queue"].numpy(),
                                   one["queue"].numpy(), rtol=0, atol=1e-6)

    def test_a_nan_on_one_rank_ends_every_rank(self, mesh, scene):
        """--debug_nans with a NaN parameter on rank 1 only: rank 1 raises
        FloatingPointError naming a module while rank 0 waits in a
        collective; the error comes out here and both ranks end, well
        within the group timeout. The group is gone after it."""
        procs = list(mesh._procs)
        t0 = time.monotonic()
        with pytest.raises(FloatingPointError, match="output of"):
            mesh.run(mc.poisoned_step, _case(scene), 1)
        assert time.monotonic() - t0 < mesh_lib.GROUP_TIMEOUT_S / 2
        assert all(p.exitcode is not None for p in procs)
        assert mesh._closed and not torch.distributed.is_initialized()


# --------------------------------------------------------------------------
# the command line
# --------------------------------------------------------------------------

def test_mesh_flags_parse_as_in_jax():
    assert cli.LEFT_OUT == ("download",)
    ours, theirs = build_parser(), jax_build_parser()
    for argv in ([], ["--n_devices", "3", "--no_mesh"]):
        a, b = ours.parse_args(argv), theirs.parse_args(argv)
        assert (a.n_devices, a.no_mesh) == (b.n_devices, b.no_mesh)
    size = lambda *argv: cli._mesh_size(ours.parse_args(
        ["--device", "cpu", *argv]))
    assert size() == 1 and size("--n_devices", "1") == 1
    assert size("--n_devices", "2") == 2
    assert size("--n_devices", "2", "--no_mesh") == 1


def test_pretrain_takes_no_mesh(monkeypatch, tmp_path):
    def refuse(*a, **k):
        raise AssertionError("--pretrain made a mesh")

    monkeypatch.setattr(cli, "make_mesh", refuse)
    monkeypatch.chdir(tmp_path)
    for k, v in dict(SCENE, VCT_SYN_H="12", VCT_SYN_W="13").items():
        monkeypatch.setenv(k, v)
    out = main(["--dataset", "Synthetic", "--folder", str(tmp_path),
                "--device", "cpu", "--pretrain", "--n_devices", "2",
                "--epoch", "1", "--batch_size", "16", "--queue_size", "32",
                "--patch_size", "5", "--log_every", "0"])
    assert np.isfinite(out["losses"]).all()


def test_run_experiments_on_two_ranks(monkeypatch, tmp_path, capfd):
    """EndNet, 1 run of 1 epoch, --device cpu --n_devices 2: a finite OA,
    the mesh line, one JSON line, and every artifact and checkpoint
    written once (by rank 0)."""
    monkeypatch.chdir(tmp_path)
    for k, v in SCENE.items():
        monkeypatch.setenv(k, v)
    out = tmp_path / "out"
    args = build_parser().parse_args([
        "--dataset", "Synthetic", "--folder", str(tmp_path), "--model",
        "EndNet", "--device", "cpu", "--n_devices", "2", "--runs", "1",
        "--epoch", "1", "--batch_size", "16", "--training_sample", "30",
        "--infer_chunk", "128", "--out_dir", str(out), "--log_every", "1"])
    (result,) = run_experiments(args)
    captured = capfd.readouterr()
    assert "mesh: 2 devices on 'data'" in captured.err
    assert np.isfinite(result["OA"]) and np.isfinite(result["losses"]).all()
    lines = [json.loads(l) for l in captured.out.splitlines()
             if l.startswith("{")]
    assert len(lines) == 1 and lines[0]["OA"] == result["OA"]
    assert captured.err.count("epoch 1/1 loss") == 1
    run_dir = out / "Synthetic_EndNet"
    metrics = (run_dir / "metrics.jsonl").read_text().splitlines()
    assert len(metrics) == 1
    assert (run_dir / "report.txt").read_text().count("Kappa") == 1
    for png in ("Ground_truth", "Prediction_run0", "confusion_matrix_run0"):
        assert (run_dir / (png + ".png")).is_file()
    files = [os.path.join(d, f) for d, _, fs in os.walk(
        tmp_path / "checkpoints") for f in fs]
    assert sorted(os.path.basename(os.path.dirname(f)) for f in files) == [
        "best_epoch", "final_epoch"]
    assert os.path.realpath(result["best_checkpoint"]) in [
        os.path.realpath(f) for f in files]


def test_serve_on_two_ranks_matches_no_mesh(monkeypatch, tmp_path):
    """--serve --n_devices 2 against --no_mesh, the same seeded weights:
    a stride-1 and a stride-2 request, maps within atol 1e-5; rank 0
    answers each request once, and quit ends both ranks."""
    for k, v in SCENE.items():
        monkeypatch.setenv(k, v)
    maps = {}
    for flag in ("--no_mesh", "--n_devices"):
        argv = ["--dataset", "Synthetic", "--folder", str(tmp_path),
                "--model", "EndNet", "--device", "cpu", "--infer_chunk",
                "128", "--serve", flag] + (["2"] if flag == "--n_devices"
                                           else [])
        reqs = [{"out": str(tmp_path / "{}1.npy".format(flag))},
                {"out": str(tmp_path / "{}2.npy".format(flag)),
                 "stride": 2}, {"cmd": "quit"}, {}]
        out_s = io.StringIO()
        served = run_serve(build_parser().parse_args(argv),
                           io.StringIO("\n".join(map(json.dumps, reqs))
                                       + "\n"), out_s)
        resps = [json.loads(l) for l in out_s.getvalue().splitlines()]
        assert served == 2 and len(resps) == 2
        assert all(r["ok"] for r in resps)
        maps[flag] = [np.load(r["out"]) for r in resps]
    for a, b in zip(maps["--no_mesh"], maps["--n_devices"]):
        assert np.abs(a).sum() > 0
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
