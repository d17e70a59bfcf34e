"""The port's profiler ranges (``utils/profiling.span``): where the
benchmark's traced runs find them, that the stride > 1 path names its
chunks and not bands, that no range is entered while no profiler runs,
and that the benchmark's readers read the program's names."""

import numpy as np
import pytest
import torch

import gpubench.run
from gpubench import spans
from gpubench.testing import run_small
from vit_cnn_tpu_torch.infer import fullscene
from vit_cnn_tpu_torch.models.registry import get_model
from vit_cnn_tpu_torch.nn.layers import init_parameters
from vit_cnn_tpu_torch.pipeline.patches import PatchPipeline
from vit_cnn_tpu_torch.train import loop
from vit_cnn_tpu_torch.train.loop import Trainer

STEP_PARTS = [loop.BATCH_SPAN, loop.FORWARD_SPAN, loop.BACKWARD_SPAN,
              loop.OPTIMIZER_SPAN]
BANDS, K = 6, 4


def traced_run(monkeypatch, cell):
    """A small CPU run of ``cell`` with ``--trace 1``: its trace and its
    generator's ``work``. The benchmark's JAX check is off (this test
    process holds the JAX package, which the port does not import)."""
    got = {}
    monkeypatch.setattr(gpubench.run, "FORBIDDEN", ())
    driver, finish = gpubench.run.driver, gpubench.run.Tracer.finish

    def keep_driver(*args, **kwargs):
        got["driver"] = driver(*args, **kwargs)
        return got["driver"]

    def keep_trace(self):
        got["trace"] = finish(self)
        return got["trace"]

    monkeypatch.setattr(gpubench.run, "driver", keep_driver)
    monkeypatch.setattr(gpubench.run.Tracer, "finish", keep_trace)
    result, _, _ = run_small(cell, trace=True)
    assert result["correct"]
    return got["trace"], got["driver"].work["traced"]


def inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_a_traced_request_holds_its_map_and_bands(monkeypatch):
    trace, work = traced_run(monkeypatch, "mamba-h13.serve")
    maps = spans.intervals(trace, fullscene.MAP_SPAN)
    bands = spans.intervals(trace, fullscene.BAND_SPAN)
    downloads = spans.intervals(trace, fullscene.DOWNLOAD_SPAN)
    assert len(maps) == work["requests"] == 1
    assert len(bands) == work["bands"] > 1
    assert all(inside(b, maps[0]) for b in bands)
    assert len(downloads) == 1 and inside(downloads[0], maps[0])
    assert downloads[0][0] >= bands[-1][1]
    # the scene is resident: no upload inside the traced request
    assert spans.intervals(trace, fullscene.UPLOAD_SPAN) == []
    assert spans.intervals(trace, fullscene.CHUNK_SPAN) == []


def test_a_traced_epoch_holds_its_steps_and_their_parts(monkeypatch):
    trace, work = traced_run(monkeypatch, "fusatnet-h13.train")
    steps = spans.intervals(trace, loop.STEP_SPAN)
    assert len(steps) == work["steps"] > 1
    parts = [(a, b, n) for n, a, b in trace.host_ops if n in STEP_PARTS]
    for step in steps:
        held = sorted(p for p in parts if inside(p[:2], step))
        assert [n for _, _, n in held] == STEP_PARTS
        for (_, end, _), (start, _, _) in zip(held, held[1:]):
            assert end <= start


def tiny_scene():
    rng = np.random.RandomState(0)
    img1 = rng.rand(10, 12, BANDS).astype(np.float32)
    img2 = rng.rand(10, 12, 1).astype(np.float32)
    gt = rng.randint(0, K, (10, 12)).astype(np.int64)
    return img1, img2, gt


def tiny_model():
    model, _, hp = get_model("EndNet", n_classes=K, n_bands=(BANDS, 1),
                             ignored_labels=[0], batch_size=16)
    init_parameters(model, 0)
    return model, hp


def serve(route):
    """A stride-1 (``band``) or stride-3 (``chunk``) map of EndNet, on a
    fresh cache (so the scene is uploaded)."""
    img1, img2, _ = tiny_scene()
    model, hp = tiny_model()
    hp = dict(hp, test_stride=1 if route == "band" else 3)
    return fullscene.full_scene_probabilities(model.eval(), img1, img2, hp,
                                              chunk=8)


def step():
    img1, img2, gt = tiny_scene()
    model, hp = tiny_model()
    pipe = PatchPipeline(img1, img2, gt, int(hp["patch_size"]), [0], K)
    trainer = Trainer(model, hp, pipe, seed=0, save_checkpoints=False)
    centers = torch.as_tensor(pipe.epoch_order(trainer.np_rng)[:16])
    return trainer._step(centers, torch.ones(len(centers)),
                         torch.zeros(()))


def test_a_strided_map_names_its_chunks():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        serve("chunk")
    names = [e.name for e in prof.events()]
    assert names.count(fullscene.MAP_SPAN) == 1
    assert names.count(fullscene.UPLOAD_SPAN) == 2          # HSI, LiDAR
    assert names.count(fullscene.CHUNK_SPAN) > 1
    assert names.count(fullscene.DOWNLOAD_SPAN) == 1
    assert fullscene.BAND_SPAN not in names


@pytest.mark.parametrize("route", ["band", "chunk", "step"])
def test_no_range_without_a_profiler(monkeypatch, route):
    """With no profiler running the program enters no
    ``record_function``: one that raises changes nothing."""
    def refuse(name):
        raise AssertionError("record_function({!r}) with no profiler"
                             .format(name))

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    out = step() if route == "step" else serve(route)
    assert np.isfinite(np.asarray(out)).all()


def test_readers_read_the_programs_names():
    assert spans.MAP == fullscene.MAP_SPAN
    assert spans.BAND == fullscene.BAND_SPAN
    assert spans.STEP == loop.STEP_SPAN
