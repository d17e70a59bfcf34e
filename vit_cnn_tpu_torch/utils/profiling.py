"""Parameter and FLOP counts, traces and named spans.

Counterpart of :mod:`vit_cnn_tpu.utils.profiling` in torch terms:

* :func:`count_params` — parameters of a module (thop's 'params');
* :func:`flops` — FLOPs of one call through
  ``torch.utils.flop_counter.FlopCounterMode`` (a per-op table of the ops
  it knows: matmuls, convolutions, attention; the custom kernels' ops are
  not counted), where the JAX package reads XLA's cost analysis;
* :func:`clever_format` — thop's G / M / K formatting;
* :func:`profile_model` — both for a model forward;
* :func:`trace` — a ``torch.profiler`` trace (CPU, and CUDA where a card
  is present) of a code region, written as a Chrome trace
  (:func:`start_trace` / :func:`stop_trace` for regions that are not one
  block);
* :func:`span` — a named ``record_function`` range while a profiler
  runs, and nothing otherwise.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import ContextManager, Dict, Iterator

import torch


def count_params(model: torch.nn.Module) -> int:
    """Total parameter count (thop 'params' equivalent)."""
    return sum(p.numel() for p in model.parameters())


def flops(fn, *args, **kwargs) -> float:
    """FLOPs of one call of ``fn(*args, **kwargs)`` (~2x thop's MACs)."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def clever_format(value: float, suffix: str = "") -> str:
    """Human format a count (thop.clever_format parity: G/M/K)."""
    for unit, div in (("G", 1e9), ("M", 1e6), ("K", 1e3)):
        if value >= div:
            return "{:.2f}{}{}".format(value / div, unit, suffix)
    return "{:.2f}{}".format(value, suffix)


def profile_model(model: torch.nn.Module, *inputs) -> Dict:
    """FLOPs + params of a model forward (the reference's
    ``thop.profile(model, inputs=(x1, x2))``)."""
    f = flops(model, *inputs)
    p = count_params(model)
    return {"flops": f, "params": p,
            "flops_str": clever_format(f), "params_str": clever_format(p)}


def start_trace(log_dir: str) -> torch.profiler.profile:
    """Start a profiler on the CPU, and on the card where there is one."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof: torch.profiler.profile, log_dir: str) -> str:
    """Stop ``prof`` and write its Chrome trace into ``log_dir``; returns
    the file path."""
    prof.stop()
    path = os.path.join(log_dir, "trace_{}_{}.json".format(
        time.strftime("%Y_%m_%d_%H_%M_%S"), os.getpid()))
    prof.export_chrome_trace(path)
    return path


#: what :func:`span` returns with no profiler running (reentrant)
_OFF = contextlib.nullcontext()


def span(name: str) -> ContextManager:
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler runs (``torch.profiler``, the CLI's ``--profile_dir``,
    ``emit_nvtx``), and a shared no-op context otherwise: a range costs
    microseconds of host time even with no profiler running, the check a
    small fraction of that."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profiler trace around a code region, written to ``log_dir``."""
    prof = start_trace(log_dir)
    try:
        yield prof
    finally:
        stop_trace(prof, log_dir)
