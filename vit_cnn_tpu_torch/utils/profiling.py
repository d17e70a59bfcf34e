"""Parameter and FLOP counts, traces and a throughput counter.

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
* :class:`Throughput` — items/s, fenced with ``torch.cuda.synchronize``
  on a CUDA tensor.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Iterator, Optional

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


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profiler trace around a code region, written to ``log_dir``."""
    prof = start_trace(log_dir)
    try:
        yield prof
    finally:
        stop_trace(prof, log_dir)


class Throughput:
    """Streaming items/s counter (patches/s, the serving and training
    metric). Pass a tensor to :meth:`update` (or call :meth:`fence`) so the
    time covers the work queued on the card, not its launch."""

    def __init__(self, n_devices: int = 1):
        self.n_devices = max(n_devices, 1)
        self.items = 0
        self.t0: Optional[float] = None

    def start(self):
        self.t0 = time.time()
        self.items = 0
        return self

    @staticmethod
    def fence(x: Any) -> None:
        """Wait for everything queued before ``x`` where it is a CUDA
        tensor."""
        if isinstance(x, torch.Tensor) and x.is_cuda:
            torch.cuda.synchronize(x.device)

    def update(self, n_items: int, fence_on: Any = None):
        if self.t0 is None:
            self.start()
        if fence_on is not None:
            self.fence(fence_on)
        self.items += n_items

    def rate(self) -> float:
        """items/s/device since start()."""
        if self.t0 is None or self.items == 0:
            return 0.0
        return self.items / (time.time() - self.t0) / self.n_devices
