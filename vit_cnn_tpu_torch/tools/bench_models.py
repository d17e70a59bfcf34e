"""Per-model serving and train rates on the card, for the 14 models of the
registry: the twin of the JAX package's ``perf/bench_models.py``.

  python -m vit_cnn_tpu_torch.tools.bench_models [--phase serve|train|both]
      [--budget_s S] [--repeats R] [--device cuda|cpu] [MODEL ...]

Every model of :data:`ALL` (the JAX tool's names, in its order) by
default, or the named ones; ``--phase`` takes the place of the JAX tool's
``VCT_BENCH_PHASE`` (the port reads no environment flags). It runs on the
card: without CUDA it exits with an error unless ``--device cpu`` is
given, which the CPU tests use at small sizes (no figure of a CPU run is
a device figure).

The scene is the Synthetic one at Houston2013's size, 349 x 1905, 144 HSI
+ 1 LiDAR bands, 15 classes (:func:`..tools.load_scene`), and the
weights are seeded (:func:`..tools.model_state`), as in ``chip_smoke.py``
and the profilers. The JAX tool draws its scene with ``np.random.rand``
and flax's initializers, so the two tables do not share inputs.

* Serving (:func:`measure_serving`) is the ``--serve`` route itself:
  ``infer/fullscene.full_scene_probabilities`` on a resident
  ``SceneCache``, bf16 policy, stride 1, chunk 8192 (4,096, then 2,048
  after an out-of-memory error, where the JAX tool shrinks its band
  rows). A band is the chunk's whole origin rows; the tool serves the
  scene's top rows that hold exactly ``BANDS`` bands, so no band is
  padded. The first call, on the top band alone (model to the card,
  upload, first forward), is ``first_band_s``; a warm-up call uploads
  the crop (a PCA model's HSI is reduced there, once). Then each of
  ``repeats`` runs serves the crop again and again until ``budget_s``
  has passed. Per run windows/s; reported: the median, the spread
  (max - min) / median, ms a band and a whole request's seconds at the
  median rate, peak memory.
* Training (:func:`measure_train`) is :func:`..tools.train_step`: the
  registry's loss and optimizer, bf16 over float32 master weights,
  flip/rotate, one fixed batch, batch 1024 (halved after an
  out-of-memory error, down to 128). The first step is
  ``first_step_s``; each of ``repeats`` runs times steady steps on the
  host clock for ``budget_s``, ending in a synchronize (patches/s and
  ms a step: median and spread). Then ``torch.profiler`` over
  ``PROFILED`` steps gives the device ms a step (the sum of the kernel
  rows, as ``tools/profile_train.py`` sums them) and busy = device ms /
  the unprofiled host ms; peak memory.

Output: the card's name and power limit (:func:`..tools.card_line`) and
the code's stamp (:func:`..tools.stamp`); the main kernel library's build (or
load) seconds, apart from any model; per model a line on stderr as each
phase ends, one JSON line with every figure and its markdown row; at
the end the whole markdown table.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import statistics
import sys
import time

import torch

from . import SCENE, card_line, load_scene, model_state, stamp, train_step
from .profile_train import _device_us, kernel_rows

ALL = ["EndNet", "Early_fusion_CNN", "Middle_fusion_CNN", "Late_fusion_CNN",
       "Cross_fusion_CNN", "S2ENet", "SpectralFormer", "S2EFT", "FusAtNet",
       "MFT", "HCTnet", "MHST", "GLT_Net", "Multimodality_Mamba"]
BANDS, CHUNK, BATCH, MIN_BATCH, PROFILED = 4, 8192, 1024, 128, 5
BUDGET_S, REPEATS = 3.0, 3


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak_gb(device):
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 1e9


def _release(device) -> None:
    """Return a failed or finished model's memory to the card."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _spread(values) -> float:
    return (max(values) - min(values)) / statistics.median(values)


def _runs(work, budget_s: float, repeats: int, device):
    """Per run: (units of work done, seconds), ``work()`` called again and
    again until ``budget_s`` has passed, then a synchronize."""
    out = []
    for _ in range(repeats):
        _sync(device)
        done, t0 = 0, time.perf_counter()
        while True:
            done += work()
            if time.perf_counter() - t0 >= budget_s:
                break
        _sync(device)
        out.append((done, time.perf_counter() - t0))
    return out


def _serve(name, scene, device, budget_s, repeats, chunk) -> dict:
    from ..infer.fullscene import SceneCache, full_scene_probabilities
    from ..models.registry import get_model

    img1, img2, _ = scene
    _reset_peak(device)
    t0 = time.perf_counter()
    model, _, hp = get_model(name, n_classes=int(SCENE["VCT_SYN_CLASSES"]),
                             n_bands=(img1.shape[2], img2.shape[2]))
    model.load_state_dict(model_state(scene, name))
    model.to(device).eval()
    hp = dict(hp, bf16=True)
    p = int(hp["patch_size"])
    wc, total = img1.shape[1] - p + 1, img1.shape[0] - p + 1
    rows = max(1, min(total, chunk // wc))     # full_scene_probabilities'
    bands = max(1, min(BANDS, total // rows))
    crop_rows = rows * bands + p - 1
    first = tuple(x[:rows + p - 1] for x in (img1, img2))
    full_scene_probabilities(model, *first, hp, chunk=chunk,
                             cache=SceneCache())
    _sync(device)
    first_band_s = time.perf_counter() - t0

    crop = tuple(x[:crop_rows] for x in (img1, img2))
    cache = SceneCache()

    def serve():
        full_scene_probabilities(model, *crop, hp, chunk=chunk, cache=cache)
        return bands

    serve()                                    # upload (and PCA) once
    windows = rows * wc
    runs = [n * windows / s for n, s in
            _runs(serve, budget_s, repeats, device)]
    rate = statistics.median(runs)
    bands_per_request = -(-total // rows)
    return {"patch": p, "chunk": chunk, "windows_per_band": windows,
            "bands": bands, "crop_rows": crop_rows,
            "bands_per_request": bands_per_request,
            "first_band_s": first_band_s, "windows_per_s": rate,
            "windows_per_s_runs": runs, "serve_spread": _spread(runs),
            "ms_per_band": windows / rate * 1e3,
            "request_s": windows / rate * bands_per_request,
            "serve_peak_gb": _peak_gb(device)}


def measure_serving(name, scene, device, budget_s: float = BUDGET_S,
                    repeats: int = REPEATS, chunk: int = CHUNK) -> dict:
    """Serving figures of the registered model ``name`` on ``scene``
    (``device`` a torch.device); the chunk halves twice after an
    out-of-memory error, and the report says which chunk served."""
    for c in (chunk, chunk // 2, chunk // 4):
        try:
            return _serve(name, scene, device, budget_s, repeats, c)
        except torch.cuda.OutOfMemoryError:
            log("{}: serving chunk {} out of memory, halving".format(name, c))
        _release(device)
    raise RuntimeError("{}: serving failed down to chunk {}".format(
        name, chunk // 4))


def _device_ms(trainer, args, device):
    """Device ms a step: the kernel rows of ``PROFILED`` profiled steps."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED):
            trainer._step(*args)
        _sync(device)
    kernels = kernel_rows(prof.key_averages())
    return sum(_device_us(e) for e in kernels) / 1e3 / PROFILED


def _train(name, scene, state, device, batch, budget_s, repeats) -> dict:
    _reset_peak(device)
    t0 = time.perf_counter()
    trainer, args = train_step(scene, state, device, batch, model=name,
                               bf16=True, flip=True)
    loss = float(trainer._step(*args))
    first_step_s = time.perf_counter() - t0

    def step():
        trainer._step(*args)
        return 1

    runs = _runs(step, budget_s, repeats, device)
    rates = [n * batch / s for n, s in runs]
    ms = [s / n * 1e3 for n, s in runs]
    host_ms = statistics.median(ms)
    device_ms = (_device_ms(trainer, args, device)
                 if device.type == "cuda" else None)
    return {"batch": batch, "first_step_s": first_step_s, "loss": loss,
            "patches_per_s": statistics.median(rates),
            "patches_per_s_runs": rates, "train_spread": _spread(rates),
            "host_ms_per_step": host_ms, "host_ms_per_step_runs": ms,
            "device_ms_per_step": device_ms,
            "busy": None if device_ms is None else device_ms / host_ms,
            "train_peak_gb": _peak_gb(device)}


def measure_train(name, scene, device, batch: int = BATCH,
                  budget_s: float = BUDGET_S,
                  repeats: int = REPEATS) -> dict:
    """Train figures of the registered model ``name`` on ``scene`` from its
    seeded weights; the batch halves after an out-of-memory error, down
    to ``MIN_BATCH`` (RuntimeError below it), and the report says which
    batch ran."""
    state = model_state(scene, name)
    while True:
        try:
            return _train(name, scene, state, device, batch, budget_s,
                          repeats)
        except torch.cuda.OutOfMemoryError:
            log("{}: batch {} out of memory, halving".format(name, batch))
        _release(device)
        batch //= 2
        if batch < MIN_BATCH:
            raise RuntimeError("{}: out of memory at every batch >= {}"
                               .format(name, MIN_BATCH))


def _fmt(v, spec="{:,.0f}"):
    return "-" if v is None else spec.format(v)


HEADER = ("| Model | patch | serving windows/s (spread) | request s | "
          "train patches/s (spread) | ms/step host / device | batch | "
          "peak GB serve / train |\n|---|---|---|---|---|---|---|---|")


def row(r: dict) -> str:
    """The markdown row of one model's report."""
    serve = ("-" if "windows_per_s" not in r else "{:,.0f} ({:.1%})".format(
        r["windows_per_s"], r["serve_spread"]))
    train = ("-" if "patches_per_s" not in r else "{:,.0f} ({:.1%})".format(
        r["patches_per_s"], r["train_spread"]))
    return "| {} | {} | {} | {} | {} | {} / {} | {} | {} / {} |".format(
        r["model"], r.get("patch", "-"), serve,
        _fmt(r.get("request_s"), "{:.3f}"), train,
        _fmt(r.get("host_ms_per_step"), "{:.2f}"),
        _fmt(r.get("device_ms_per_step"), "{:.2f}"), r.get("batch", "-"),
        _fmt(r.get("serve_peak_gb"), "{:.2f}"),
        _fmt(r.get("train_peak_gb"), "{:.2f}"))


def bench(name, scene, device, phase, budget_s, repeats) -> dict:
    """One model's report: its serving and / or train figures."""
    report = {"model": name}
    if phase in ("serve", "both"):
        s = measure_serving(name, scene, device, budget_s, repeats)
        log("{}: serving first band {:.2f} s; {:,.0f} windows/s (spread "
            "{:.1%}, chunk {}, {} windows a band), {:.3f} s a request"
            .format(name, s["first_band_s"], s["windows_per_s"],
                    s["serve_spread"], s["chunk"], s["windows_per_band"],
                    s["request_s"]))
        report.update(s)
        _release(device)
    if phase in ("train", "both"):
        t = measure_train(name, scene, device, budget_s=budget_s,
                          repeats=repeats)
        log("{}: train first step {:.2f} s; {:,.0f} patches/s (spread "
            "{:.1%}) at batch {}, {:.2f} ms a step host, {} device, loss "
            "{:.4f}".format(name, t["first_step_s"], t["patches_per_s"],
                            t["train_spread"], t["batch"],
                            t["host_ms_per_step"],
                            _fmt(t["device_ms_per_step"], "{:.2f} ms"),
                            t["loss"]))
        report.update(t)
        _release(device)
    return report


def _finite(report: dict) -> bool:
    rates = [report[k] for k in ("windows_per_s", "patches_per_s")
             if k in report]
    return all(math.isfinite(v) and v > 0 for v in rates)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("models", nargs="*", metavar="MODEL")
    parser.add_argument("--phase", choices=("serve", "train", "both"),
                        default="both")
    parser.add_argument("--budget_s", type=float, default=BUDGET_S)
    parser.add_argument("--repeats", type=int, default=REPEATS)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    unknown = sorted(set(args.models) - set(ALL))
    if unknown:
        parser.error("unknown models {}; choose from {}".format(unknown,
                                                                ALL))
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_models: CUDA is not available (--device "
                         "cpu runs on the CPU, at no device figure)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(args.device)
    print(card_line() if device.type == "cuda" else
          "cpu: no device figures", flush=True)
    print("stamp: {}".format(stamp()), flush=True)
    if device.type == "cuda":
        from ..ops import _build

        t0 = time.perf_counter()
        _build.lib()
        print("kernel library {} in {:.1f} s".format(
            "built" if "kernels" in _build.build_seconds else "loaded",
            time.perf_counter() - t0), flush=True)
    scene = load_scene()
    reports = []
    for name in args.models or ALL:
        report = bench(name, scene, device, args.phase, args.budget_s,
                       args.repeats)
        reports.append(report)
        print(json.dumps(report), flush=True)
        print(row(report), flush=True)
    print()
    print(HEADER)
    for report in reports:
        print(row(report))
    return 0 if all(_finite(r) for r in reports) else 1


if __name__ == "__main__":
    raise SystemExit(main())
