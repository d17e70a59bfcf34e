"""The program's own profiler ranges in a traced span, for the readers
that split the device's idle time and count kernel launches by what the
host was doing.

The port opens named ranges while a profiler runs
(``vit_cnn_tpu_torch/utils/profiling.py`` ``span``): one whole map, each
band of the stride-1 loop (``infer/fullscene.py``) and each optimizer
step (``train/loop.py``). They are host operations of the same trace as
the device's, on the profiler's one clock. Only ranges that lie whole
inside the traced span count: the profiler also records the untraced
request or epoch ahead of it and whatever runs after it. A program
without the ranges (an older commit) has none, and every reader of them
returns ``None``.

The names are spelled out here, not imported, so that the readers run
against any commit of the program. The ranges the readers expect:

=================  ====================================  ==================================
Range              Opened by                             Read by
=================  ====================================  ==================================
``fullscene.map``  ``full_scene_probabilities``, once a  ``serve.edge_idle_ms_per_req``
                   map                                   (its count)
``fullscene.band`` each band of the stride-1 loop        ``serve.band_idle_ms_per_band``,
                                                         ``serve.launches_per_band``,
                                                         ``serve.edge_idle_ms_per_req``
                                                         (outside them)
``trainer.step``   ``Trainer._step``, once a step        ``train.step_idle_ms_per_step``,
                                                         ``train.launches_per_step``,
                                                         ``train.edge_idle_ms_per_epoch``
                                                         (outside them)
=================  ====================================  ==================================

A cell's two idle metrics, times their counts, add up to
``window_s - busy_s``. Each reader divides by the count of its own
ranges (the epoch edge by the traced epochs), and returns ``None`` where
the ranges are absent or the device ran nothing (a CPU run).

The port also opens ``fullscene.upload`` (a scene's upload on a cache
miss), ``fullscene.chunk`` (each chunk at stride > 1),
``fullscene.download``, and ``trainer.batch``, ``trainer.forward``,
``trainer.backward`` and ``trainer.optimizer`` inside each step. No
metric reads them; they name the idle gaps of a run's ``breakdown``.
"""

from __future__ import annotations

import bisect
from typing import List, Tuple

from .trace import PROFILER_OPS, Trace, _overlap, _union

#: ``vit_cnn_tpu_torch/infer/fullscene.py`` ``MAP_SPAN``: one whole map
MAP = "fullscene.map"
#: ``fullscene.py`` ``BAND_SPAN``: one band of the stride-1 loop
BAND = "fullscene.band"
#: ``vit_cnn_tpu_torch/train/loop.py`` ``STEP_SPAN``: one optimizer step
STEP = "trainer.step"

#: host calls that launch device work: the runtime's and the driver's
#: kernel launches (every variant), and a CUDA graph's launch
LAUNCH_PREFIXES = ("cudaLaunchKernel", "cuLaunchKernel")
GRAPH_LAUNCH = "cudaGraphLaunch"

Intervals = List[Tuple[int, int]]


def intervals(trace: Trace, name: str) -> Intervals:
    """The ranges named ``name`` that lie whole inside the traced span,
    in order of start, one per range (on any thread)."""
    return sorted((a, b) for n, a, b in trace.host_ops
                  if n == name and a >= trace.t0 and b <= trace.t1)


def _intersect(xs: Intervals, ys: Intervals) -> Intervals:
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle_s(trace: Trace, within: Intervals) -> float:
    """Seconds of device idle time inside the union of ``within``, less
    the idle time while the host was in the profiler's own operations
    (:data:`gpubench.trace.PROFILER_OPS`), as ``Trace.window_s`` leaves
    it out."""
    idle = _intersect(trace.gaps(), _union(within))
    stalls = _union([(a, b) for n, a, b in trace.host_ops
                     if n in PROFILER_OPS])
    total = sum(b - a for a, b in idle)
    return (total - _overlap(idle, stalls)) / 1e9


def edge_idle_s(trace: Trace, spans: Intervals) -> float:
    """Seconds of device idle time in the traced span outside every one
    of ``spans`` (less the profiler's own, as :func:`idle_s`): with
    :func:`idle_s` of ``spans`` it adds up to ``window_s - busy_s``."""
    return idle_s(trace, [(trace.t0, trace.t1)]) - idle_s(trace, spans)


def launches(trace: Trace, within: Intervals) -> int:
    """The launch calls (:data:`LAUNCH_PREFIXES`, :data:`GRAPH_LAUNCH`)
    whose host start lies inside the union of ``within``, on any thread:
    the backward launches from autograd's own thread while the step's
    thread waits."""
    starts = sorted(a for n, a, _ in trace.host_ops
                    if n.startswith(LAUNCH_PREFIXES) or n == GRAPH_LAUNCH)
    return sum(bisect.bisect_left(starts, b) - bisect.bisect_left(starts, a)
               for a, b in _union(within))
