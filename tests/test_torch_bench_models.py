"""The per-model table tool (``vit_cnn_tpu_torch/tools/bench_models.py``) on
the CPU, at small sizes (``--device cpu``; its figures there are CPU
figures, which the tool prints as such).

* ``ALL`` is the JAX tool's list (``perf/bench_models.py``, read with
  ``ast``: that module imports JAX and runs nothing we need) and the
  port's registry.
* ``measure_serving`` for EndNet and HCTnet (its PCA path) on a top crop
  of a 20 x 24 scene at a small chunk: finite, positive rates, and the
  windows a band it counts are what ``full_scene_probabilities`` serves
  for that crop and chunk (a spy on the function counts the model's
  windows per call).
* ``measure_train`` for EndNet at batch 8; the batch halving on
  ``torch.cuda.OutOfMemoryError`` (a step raising above 256 reports 256;
  one raising above 64 runs out of batches and raises RuntimeError).
* ``main`` prints the header, one JSON line and one row; without CUDA and
  without ``--device cpu`` it exits with an error.
"""

import ast
import json
import os

import pytest
import torch

from vit_cnn_tpu_torch.data import get_dataset
from vit_cnn_tpu_torch.infer import fullscene
from vit_cnn_tpu_torch.models.registry import model_names
from vit_cnn_tpu_torch.tools import bench_models

SCENE = {"VCT_SYN_H": "20", "VCT_SYN_W": "24", "VCT_SYN_BANDS": "32",
         "VCT_SYN_CLASSES": "6"}
CPU = torch.device("cpu")
FAST = dict(budget_s=0.01, repeats=2)
JAX_TOOL = os.path.join(os.path.dirname(__file__), "..", "perf",
                        "bench_models.py")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def scene(monkeypatch, tmp_path):
    for k, v in SCENE.items():
        monkeypatch.setenv(k, v)
    return get_dataset("Synthetic", str(tmp_path))[:3]


def test_all_is_the_jax_tools_list_and_the_registry():
    with open(JAX_TOOL) as f:
        tree = ast.parse(f.read())
    lists = [ast.literal_eval(node.value) for node in tree.body
             if isinstance(node, ast.Assign)
             and [ast.unparse(t) for t in node.targets] == ["ALL"]]
    assert lists == [bench_models.ALL]
    assert set(bench_models.ALL) == set(model_names())
    assert len(bench_models.ALL) == 14


@pytest.mark.parametrize("name,chunk", [("EndNet", 48), ("HCTnet", 28)])
def test_serving_counts_what_full_scene_probabilities_serves(
        scene, monkeypatch, name, chunk):
    calls = []
    real = fullscene.full_scene_probabilities

    def spy(model, img1, img2, hp, chunk, cache):
        sizes = []
        hook = model.register_forward_hook(
            lambda m, args, out: sizes.append(args[0].shape[0]))
        try:
            return real(model, img1, img2, hp, chunk=chunk, cache=cache)
        finally:
            hook.remove()
            calls.append((img1.shape[0], chunk, sizes))

    monkeypatch.setattr(fullscene, "full_scene_probabilities", spy)
    r = bench_models.measure_serving(name, scene, CPU, chunk=chunk, **FAST)
    assert r["chunk"] == chunk and r["bands"] == bench_models.BANDS
    first, warm, *timed = calls
    p = r["patch"]
    rows = r["windows_per_band"] // (24 - p + 1)      # origin rows a band
    assert r["windows_per_band"] == rows * (24 - p + 1)
    assert r["crop_rows"] == rows * r["bands"] + p - 1
    assert first == (rows + p - 1, chunk, [r["windows_per_band"]])
    for n_rows, c, sizes in [warm] + timed:
        assert (n_rows, c) == (r["crop_rows"], chunk)
        assert sizes == [r["windows_per_band"]] * r["bands"]
    assert len(timed) >= 2                    # one call or more a run
    assert r["bands_per_request"] == -(-(20 - p + 1) // rows)
    for k in ("windows_per_s", "ms_per_band", "request_s", "first_band_s"):
        assert r[k] > 0 and r[k] < float("inf"), k
    assert len(r["windows_per_s_runs"]) == 2 and r["serve_spread"] >= 0
    assert r["serve_peak_gb"] is None         # no device figure on the CPU


def test_train_at_batch_8(scene):
    r = bench_models.measure_train("EndNet", scene, CPU, batch=8, **FAST)
    assert r["batch"] == 8
    for k in ("patches_per_s", "host_ms_per_step", "first_step_s"):
        assert 0 < r[k] < float("inf"), k
    assert torch.isfinite(torch.tensor(r["loss"]))
    assert r["device_ms_per_step"] is None and r["busy"] is None


@pytest.mark.parametrize("limit,want", [(256, 256), (64, None)])
def test_train_halves_the_batch_when_out_of_memory(scene, monkeypatch,
                                                   limit, want):
    tried = []
    real = bench_models.train_step

    def step(scene, state, device, batch, **kw):
        tried.append(batch)
        if batch > limit:
            raise torch.cuda.OutOfMemoryError("out of memory at {}".format(
                batch))
        return real(scene, state, device, batch, **kw)

    monkeypatch.setattr(bench_models, "train_step", step)
    if want is None:
        with pytest.raises(RuntimeError, match="batch >= 128"):
            bench_models.measure_train("EndNet", scene, CPU, budget_s=0.01,
                                       repeats=1)
        assert tried == [1024, 512, 256, 128]
    else:
        r = bench_models.measure_train("EndNet", scene, CPU, budget_s=0.01,
                                       repeats=1)
        assert r["batch"] == want and tried == [1024, 512, 256]


def test_main_prints_the_header_a_json_line_and_a_row(scene, monkeypatch,
                                                      capsys):
    monkeypatch.setattr(bench_models, "load_scene", lambda: scene)
    assert bench_models.main(["--device", "cpu", "--phase", "serve",
                              "--budget_s", "0.01", "--repeats", "1",
                              "EndNet"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "cpu: no device figures"
    assert out[1].startswith("stamp: ") and "tree " in out[1]
    reports = [json.loads(line) for line in out if line.startswith("{")]
    assert len(reports) == 1 and reports[0]["model"] == "EndNet"
    row = bench_models.row(reports[0])
    header = bench_models.HEADER.splitlines()
    i = out.index(header[0])
    assert out[i + 1:] == [header[1], row]
    assert row.startswith("| EndNet | 1 | ") and "- / -" in row


def test_main_without_cuda_exits_with_an_error(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA is not available"):
        bench_models.main(["EndNet"])
