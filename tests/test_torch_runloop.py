"""The port's run loop (``run_experiments``) against the JAX package's, on
the CPU.

Three runs of one epoch each on a tiny Synthetic scene (16 x 20, 20 + 1
bands, 3 real classes), with ``--strict_seed_parity`` 1 and 0: each run's
split equals the JAX ``_load_gt_pair`` for the same seeds, each trainer
gets the JAX model seed, ``report.txt`` is the JAX ``show_results`` text
of the same metrics, the artifacts carry the JAX writer's file names for
the same calls and the maps its pixels (read with PIL), and the best file
of a run served through ``--serve --restore`` gives that run's OA, AA and
Kappa exactly. Then the sampling modes and ``--train_set`` /
``--test_set`` against JAX, the command line's flags against the JAX
parser's, the PNG codec, the seeding and the profiling helpers.
"""

import io
import json
import os
import re

import numpy as np
import pytest
import scipy.io
import torch
from PIL import Image

from vit_cnn_tpu import cli as jax_cli
from vit_cnn_tpu.data import sampling as jax_sampling
from vit_cnn_tpu.metrics.report import show_results as jax_show_results
from vit_cnn_tpu.utils import profiling as jax_profiling
from vit_cnn_tpu.utils import seeding as jax_seeding
from vit_cnn_tpu.utils.viz import ArtifactWriter as JaxWriter
from vit_cnn_tpu_torch import cli
from vit_cnn_tpu_torch.data import sampling
from vit_cnn_tpu_torch.utils import profiling, seeding, viz

SCENE = {"VCT_SYN_H": "16", "VCT_SYN_W": "20", "VCT_SYN_BANDS": "20",
         "VCT_SYN_CLASSES": "4"}
RUNS = 3


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one thread: the flagship's CPU steps take as long as on
    four alone, and do not stall when the suite's workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def scene_env(monkeypatch, tmp_path):
    for k, v in SCENE.items():
        monkeypatch.setenv(k, v)
    monkeypatch.chdir(tmp_path)               # ./checkpoints, ./results


def _record(monkeypatch):
    """Wrap the CLI's split, Trainer, metrics and artifact writer; returns
    what they saw."""
    seen = {"splits": [], "seeds": [], "metrics": [], "calls": []}

    def load_gt_pair(*args, split_seed):
        state = np.random.get_state()
        got = real_load(*args, split_seed=split_seed)
        after = np.random.get_state()
        np.random.set_state(state)
        want = jax_cli._load_gt_pair(*args, split_seed=split_seed)
        np.random.set_state(after)
        seen["splits"].append((split_seed, state[1][:4].copy(), got, want))
        return got

    class Trainer(cli.Trainer):
        def __init__(self, *args, seed, **kwargs):
            seen["seeds"].append(seed)
            super().__init__(*args, seed=seed, **kwargs)

    def metrics(*args, **kwargs):
        m = real_metrics(*args, **kwargs)
        seen["metrics"].append(m)
        return m

    class Writer(cli.ArtifactWriter):
        def __getattribute__(self, name):
            attr = super().__getattribute__(name)
            if callable(attr) and not name.startswith("_"):
                def call(*args, **kwargs):
                    seen["calls"].append((name, args, kwargs))
                    return attr(*args, **kwargs)
                return call
            return attr

    real_load, real_metrics = cli._load_gt_pair, cli.metrics
    monkeypatch.setattr(cli, "_load_gt_pair", load_gt_pair)
    monkeypatch.setattr(cli, "Trainer", Trainer)
    monkeypatch.setattr(cli, "metrics", metrics)
    monkeypatch.setattr(cli, "ArtifactWriter", Writer)
    return seen


@pytest.mark.parametrize("strict", [1, 0])
def test_run_experiments_is_the_jax_run_loop(scene_env, tmp_path,
                                             monkeypatch, capsys, strict):
    seen = _record(monkeypatch)
    args = cli.build_parser().parse_args([
        "--dataset", "Synthetic", "--device", "cpu", "--runs", str(RUNS),
        "--epoch", "1", "--batch_size", "64", "--training_sample", "20",
        "--infer_chunk", "128", "--log_every", "0",
        "--strict_seed_parity", str(strict)])
    results = cli.run_experiments(args)
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert lines[:RUNS] == json.loads(json.dumps(results))
    assert lines[RUNS]["runs"] == RUNS and len(lines) == RUNS + 1
    np.testing.assert_allclose(
        [lines[RUNS]["OA_mean"], lines[RUNS]["Kappa_std"]],
        [np.mean([r["OA"] for r in results]),
         np.std([r["Kappa"] for r in results])])

    # seeds and splits (ref: main.py:378-394)
    model_seeds = [2 if strict else run for run in range(RUNS)]
    assert seen["seeds"] == model_seeds
    for run, (split_seed, state, got, want) in enumerate(seen["splits"]):
        assert split_seed == run
        np.random.seed(model_seeds[run])       # seeded just before
        np.testing.assert_array_equal(state, np.random.get_state()[1][:4])
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)

    # the report: show_results of each run, then the aggregate
    labels = ["Unclassified", "Class 1", "Class 2", "Class 3"]
    text = "".join(jax_show_results(run, m, label_values=labels) + "\n"
                   for run, m in enumerate(seen["metrics"]))
    text += jax_show_results(RUNS - 1, seen["metrics"], label_values=labels,
                             agregated=True) + "\n"
    out = os.path.join("results", "Synthetic_Multimodality_Mamba")
    with open(os.path.join(out, "report.txt")) as f:
        assert f.read() == text

    # the artifacts: the JAX writer given the same calls
    jax_out = str(tmp_path / "jax_artifacts")
    jw = JaxWriter(jax_out)
    for name, a, kw in seen["calls"]:
        getattr(jw, name)(*a, **kw)
    names = sorted(os.listdir(out))
    assert names == sorted(os.listdir(jax_out))
    assert "Prediction_run2.png" in names and \
        "confusion_matrix_run1.png" in names
    for name in names:
        if name.endswith(".png") and not name.startswith("confusion"):
            want = np.asarray(Image.open(os.path.join(jax_out, name)))
            got = np.asarray(Image.open(os.path.join(out, name)))
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                viz.read_png(os.path.join(out, name)), want)
    strip = lambda path: [{k: v for k, v in json.loads(l).items()
                           if k != "ts"} for l in open(path)]
    assert strip(os.path.join(out, "metrics.jsonl")) == \
        strip(os.path.join(jax_out, "metrics.jsonl"))

    # checkpoints under the JAX names; run 1's best file served back
    for r in results:
        for kind in ("best", "final"):
            path = r[kind + "_checkpoint"]
            assert os.path.exists(path)
            assert "/multimodalitymamba/Synthetic/train/{}_epoch/".format(
                kind) in path
            assert re.search(r"\d{{4}}(_\d\d){{5}}Multimodality_Mamba_run{}_"
                             r"epoch1_\d+\.\d\d\.msgpack$".format(r["run"]),
                             path)
    np.save("test_gt.npy", seen["splits"][1][2][1])
    serve = cli.build_parser().parse_args([
        "--dataset", "Synthetic", "--device", "cpu", "--serve",
        "--infer_chunk", "128", "--restore", results[1]["best_checkpoint"]])
    stream = io.StringIO()
    cli.run_serve(serve, io.StringIO('{"gt": "test_gt.npy"}\n'), stream)
    resp = json.loads(stream.getvalue())
    assert [resp["OA"], resp["AA"], resp["Kappa"]] == \
        [results[1]["OA"], results[1]["AA"], results[1]["Kappa"]]


def test_run_experiments_refuses_what_is_not_ported(scene_env):
    for flags, err, match in (
            (["--device", "cuda"], RuntimeError, "CUDA is not available"),):
        if flags[0] == "--device" and torch.cuda.is_available():
            continue
        args = cli.build_parser().parse_args(
            ["--dataset", "Synthetic", "--device", "cpu"] + flags)
        with pytest.raises(err, match=match):
            cli.run_experiments(args)
    assert not os.path.exists("results")     # refused before any artifact


# --------------------------------------------------------------------------
# splits
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode,size", [("fixed", 0.5), ("fixed", 10),
                                       ("disjoint", 0.5), ("disjoint", 0.3)])
def test_sampling_modes_match_jax(mode, size):
    gt = np.random.RandomState(5).randint(0, 5, (30, 24))
    np.random.seed(13)
    want = jax_sampling.sample_gt(gt, size, mode=mode)
    np.random.seed(13)
    got = sampling.sample_gt(gt, size, mode=mode)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[0].any() and got[1].any()


@pytest.mark.parametrize("which", ["both", "train", "test"])
def test_train_and_test_sets_match_jax(tmp_path, which):
    rng = np.random.RandomState(6)
    gt = rng.randint(0, 4, (18, 22))
    train, test = str(tmp_path / "train"), str(tmp_path / "test")
    if which == "both":
        scipy.io.savemat(train + ".mat", {"TRLabel": rng.randint(0, 4, gt.shape)
                                          .astype(np.uint8)})
        scipy.io.savemat(test + ".mat", {"TSLabel": rng.randint(0, 4, gt.shape)
                                         .astype(np.uint8)})
        sets = (train + ".mat", test + ".mat")
    else:
        np.save(train + ".npy", (rng.rand(*gt.shape) < 0.2) * gt)
        np.save(test + ".npy", (rng.rand(*gt.shape) < 0.5) * gt)
        sets = (train + ".npy", None) if which == "train" else \
            (None, test + ".npy")
    np.random.seed(2)
    want = jax_cli._load_gt_pair(*sets, gt, "random_fixednumber", 5,
                                 split_seed=1)
    np.random.seed(2)
    got = cli._load_gt_pair(*sets, gt, "random_fixednumber", 5, split_seed=1)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int64
        np.testing.assert_array_equal(g, w)


# --------------------------------------------------------------------------
# the command line
# --------------------------------------------------------------------------

def test_every_jax_flag_is_ported_but_the_left_out():
    """Every flag of the JAX parser has its twin (same type, default,
    action, choices), except the ones named in LEFT_OUT."""
    ours = {a.dest: a for a in cli.build_parser()._actions}
    theirs = {a.dest: a for a in jax_cli.build_parser()._actions}
    assert set(cli.LEFT_OUT) <= set(theirs)
    missing = sorted(set(theirs) - set(ours) - set(cli.LEFT_OUT))
    assert not missing, missing
    assert not set(cli.LEFT_OUT) & set(ours)
    for dest, a in theirs.items():
        if dest in cli.LEFT_OUT:
            continue
        b = ours[dest]
        assert (b.type, b.default, type(b), b.choices, b.option_strings) == \
            (a.type, a.default, type(a), a.choices, a.option_strings), dest


def test_serve_restore_refuses_a_missing_entry(scene_env, tmp_path):
    from vit_cnn_tpu_torch.train import msgpack

    path = str(tmp_path / "empty.msgpack")
    with open(path, "wb") as f:
        f.write(msgpack.packb({"params": {}, "batch_stats": {}}))
    args = cli.build_parser().parse_args([
        "--dataset", "Synthetic", "--device", "cpu", "--serve", "--restore",
        path])
    with pytest.raises(KeyError, match="left unset"):
        cli.run_serve(args, io.StringIO(""), io.StringIO())


# --------------------------------------------------------------------------
# artifacts, seeding, profiling
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(7, 9), (7, 9, 3), (5, 300, 4)])
def test_png_codec_matches_pil(tmp_path, shape):
    arr = np.random.RandomState(0).randint(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "a.png")
    viz.write_png(path, arr)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), arr)
    np.testing.assert_array_equal(viz.read_png(path), arr)
    Image.fromarray(np.zeros((40, 40, 3), np.uint8) + 9).save(path)
    with pytest.raises(ValueError, match="filters other than 0"):
        viz.read_png(path)


def test_writer_scales_spectra_and_heatmap_like_jax(tmp_path):
    rng = np.random.RandomState(1)
    img = rng.rand(12, 10, 6).astype(np.float32)
    gt = rng.randint(0, 4, (12, 10))
    labels = ["u", "a", "b", "c"]
    ours, theirs = viz.ArtifactWriter(str(tmp_path / "o")), \
        JaxWriter(str(tmp_path / "j"))
    got = ours.explore_spectrums(img, gt, labels)
    want = theirs.explore_spectrums(img, gt, labels)
    assert list(got) == list(want) == ["a", "b", "c"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    with open(str(tmp_path / "o" / "mean_spectrums.json")) as f:
        curves = json.load(f)
    np.testing.assert_allclose(curves["b"]["mean"], want["b"], rtol=1e-6)
    lidar, fm = rng.rand(12, 10, 1) * 7 - 2, rng.randn(2, 3, 5, 5)
    for w in (ours, theirs):
        w.save_lidar(lidar)
        w.show_featuremap("f", fm)
    for name in ("lidar.png", "featuremap_f.png"):
        np.testing.assert_array_equal(
            np.asarray(Image.open(str(tmp_path / "o" / name))),
            np.asarray(Image.open(str(tmp_path / "j" / name))))
    cm = np.arange(9).reshape(3, 3)
    heat = viz.heatmap(cm, cell=2)
    assert heat.shape == (6, 6, 3) and heat.dtype == np.uint8
    np.testing.assert_array_equal(heat[0, 0], [68, 1, 84])      # viridis 0
    np.testing.assert_array_equal(heat[-1, -1], [253, 231, 37])  # viridis 1


def test_seed_everything_seeds_like_jax():
    jax_seeding.seed_everything(5)
    want = (np.random.rand(3), __import__("random").random())
    seeding.seed_everything(5)
    got = (np.random.rand(3), __import__("random").random())
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    a = torch.rand(3)
    seeding.seed_everything(5)
    assert torch.equal(torch.rand(3), a)


def test_profiling_counts_and_traces(tmp_path):
    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.ReLU(),
                                torch.nn.Linear(16, 4))
    assert profiling.count_params(model) == 8 * 16 + 16 + 16 * 4 + 4
    x = torch.randn(5, 8)
    assert profiling.flops(model, x) == 2 * 5 * (8 * 16 + 16 * 4)
    report = profiling.profile_model(model, x)
    assert report["params_str"] == jax_profiling.clever_format(212)
    for v in (3.0, 4.5e3, 7.25e6, 1.5e10):
        assert profiling.clever_format(v, "FLOPs") == \
            jax_profiling.clever_format(v, "FLOPs")
    with profiling.trace(str(tmp_path / "tr")):
        model(x)
    (trace,) = os.listdir(str(tmp_path / "tr"))
    with open(str(tmp_path / "tr" / trace)) as f:
        assert json.load(f)["traceEvents"]
