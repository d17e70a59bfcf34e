"""Run one cell of the benchmark and print its result line.

  python -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the port (``vit_cnn_tpu_torch``),
on a machine with as many CUDA cards as the cell asks for. With
``--trace 0`` the result's metrics are the cell's end-to-end metrics;
with ``--trace 1`` its per-layer metrics, read from a ``torch.profiler``
trace of part of the window (:mod:`gpubench.trace`), with the device's
busy and traced seconds. Every run checks that what the window produced
is correct and prints each compared number beside its limit, as the last
lines of standard error and under ``checks``, the last key of the result
line, which is the last line of standard output.

Exit codes: 0 with a result (``correct`` true or false); another code
and no result for a missing card, a JAX module loaded in this process
(:data:`FORBIDDEN`, by top-level name), or a failure.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

#: top-level module names that no process of the benchmark may load
FORBIDDEN = ("jax", "jaxlib", "flax", "vit_cnn_tpu")


def process_seconds() -> float:
    """Seconds since this process started (``/proc/self/stat``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules(names) -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of :data:`FORBIDDEN`, compared whole."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def cache_dirs(root: Path) -> None:
    """Fixed build and kernel-cache directories inside the checkout (the
    port's kernel library builds in ``build/vit_cnn_tpu_torch`` by
    itself)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        path = root / "build" / "gpubench" / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def driver(info, seed, device, fault=None):
    """The generator of the cell's traffic ``kind``, once the mix is found
    to hold only the keys it reads and, of those it fixes, its values."""
    mix = info["traffic"]
    kind = mix["kind"]
    if kind == "serve":
        from .serve import Serve as gen
    elif kind == "train":
        from .train import Train as gen
    else:
        raise ValueError("no generator for traffic kind {!r}".format(kind))
    unknown = sorted(set(mix) - set(gen.KEYS))
    fixed = {k: v for k, v in gen.FIXED.items() if mix.get(k, v) != v}
    if unknown or fixed:
        raise ValueError("the {} generator reads no {} and implements only "
                         "{}".format(kind, unknown, gen.FIXED))
    return gen(info, seed, device, fault)


class Tracer:
    """Profiles the spans the generator opens (:meth:`span`) into one
    trace; the traced span runs from the first span's start to the last
    one's end. The generator starts the profiler (:meth:`start`) one
    untraced request or epoch ahead of the first span, so that the
    profiler's own start-up falls outside the span."""

    NAME = "gpubench.traced"

    def __init__(self, device):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.device = torch.device(device)
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)

    def start(self):
        self.prof.start()

    def span(self):
        import contextlib

        import torch

        @contextlib.contextmanager
        def spanned():
            with torch.profiler.record_function(self.NAME):
                yield
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        return spanned()

    def finish(self):
        from .trace import Trace

        self.prof.stop()
        return Trace.from_profiler(self.prof, self.NAME)


def per_layer(name, trace, counts, work, bench):
    """The cell's per-layer metrics that their readers find something to
    read for."""
    from . import layout

    ctx = {"trace": trace, "counts": counts, "work": work}
    out = {}
    for m in layout.metrics_for(name, True, bench):
        value = layout.module("metrics", m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", fault=None, info=None, out=None, err=None):
    """Set up, measure and check one cell; print and return the result
    line's object. Tests pass ``info`` (a smaller scene) and ``fault``
    (a wrapper that breaks the program's model)."""
    import torch

    from . import layout

    out, err = out or sys.stdout, err or sys.stderr
    bench = layout.benchmark()
    info = info or layout.cell(workload, bench)
    cfg_name = info["config"]["name"]
    drv = driver(info, seed, device, fault)
    drv.setup()
    setup_s = process_seconds()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    tracer = Tracer(device) if trace else None
    rates = drv.window(seconds, tracer)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    tr = tracer.finish() if tracer else None
    drv.release()
    numbers = drv.check()
    limits = info["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(v["value"] == v["value"] and v["value"] <= v["limit"]
                  for v in checks.values())
    metrics = {}
    if trace:
        metrics = per_layer(workload, tr, layout.module("counts", cfg_name),
                            drv.work, bench)
    else:
        units = {m["name"]: m["unit"]
                 for m in layout.metrics_for(workload, False, bench)}
        for k, v in dict(rates, setup_s=setup_s).items():
            if k in units:
                metrics[k] = {"value": v, "unit": units[k]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": drv.work["attempted"],
              "failed": drv.work.get("failed", 0),
              "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(10),
                               "idle_gaps": tr.idle_gaps(10)}
    result["checks"] = checks
    loaded = forbidden_modules(sys.modules)
    if loaded:
        print("gpubench: forbidden modules loaded: {}".format(
            ", ".join(loaded)), file=err)
        raise SystemExit(2)
    if tr is not None:
        print("trace: span {!r} s, of which device idle in profiler "
              "operations {!r} s".format((tr.t1 - tr.t0) / 1e9,
                                         tr.profiler_idle_ns / 1e9), file=err)
    for k, v in checks.items():
        print("check {}: {!r} (limit {!r})".format(k, v["value"],
                                                     v["limit"]), file=err)
    print(json.dumps(result), file=out, flush=True)
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from . import layout

    chips = layout.cell(args.workload)["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("gpubench: {} CUDA device(s) wanted, {} found".format(
            chips, torch.cuda.device_count() if torch.cuda.is_available()
            else 0), file=sys.stderr)
        return 2
    cache_dirs(layout.ROOT)
    run(args.workload, args.seed, args.seconds, bool(args.trace))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
