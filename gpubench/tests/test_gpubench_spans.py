"""The readers of the program's ranges (:mod:`gpubench.spans`) on a
made-up trace."""

import pytest

from gpubench import layout, spans
from gpubench.trace import Trace

MS = 1_000_000      # ns
SERVE = ("serve.band_idle_ms_per_band", "serve.edge_idle_ms_per_req",
         "serve.launches_per_band")
TRAIN = ("train.step_idle_ms_per_step", "train.edge_idle_ms_per_epoch",
         "train.launches_per_step")


def read(name, trace, epochs=1):
    ctx = {"trace": trace, "counts": None,
           "work": {"traced": {"epochs": epochs}}}
    return layout.module("metrics", name).read(ctx)


def made_up(outer, inner, stall=None):
    """A traced span of 0-20 ms holding one ``outer`` range (1-19 ms) and
    two ``inner`` ranges (2-8 and 8-14 ms); one more ``inner`` range
    before the span, as the profiler records the untraced request ahead.
    The device runs 0-3, 4-7, 9-14 and 15-17 ms: idle 3-4, 7-8 (first
    inner), 8-9 (second), 14-15 and 17-20 ms (edges). Launches start at
    2.5, 3, 5 (first inner), 8, 9.5 (second; a driver launch and a graph
    launch), 15.5 (edge) and -7 ms (before the span); a copy at 10 ms is
    no launch."""
    device = [("k", 0, 3 * MS), ("k", 4 * MS, 7 * MS), ("k", 9 * MS, 14 * MS),
              ("k", 15 * MS, 17 * MS), ("k", -9 * MS, -6 * MS)]
    host = [("gpubench.traced", 0, 20 * MS), (outer, 1 * MS, 19 * MS),
            (inner, 2 * MS, 8 * MS), (inner, 8 * MS, 14 * MS),
            (inner, -10 * MS, -5 * MS),
            ("cudaLaunchKernel", 2500000, 2600000),
            ("cudaLaunchKernel", 3 * MS, 3100000),
            ("cudaLaunchKernelExC", 5 * MS, 9 * MS),
            ("cudaLaunchKernel", 8 * MS, 8100000),
            ("cuLaunchKernelEx", 9500000, 9600000),
            ("cudaGraphLaunch", 9500000, 9700000),
            ("cudaMemcpyAsync", 10 * MS, 11 * MS),
            ("cudaLaunchKernel", 15500000, 15600000),
            ("cudaLaunchKernel", -7 * MS, -7 * MS + 1000)]
    if stall:
        host.append(("Activity Buffer Request",) + stall)
    return Trace(device, host, 0, 20 * MS)


def test_serving_readers():
    t = made_up(spans.MAP, spans.BAND)
    assert read("serve.band_idle_ms_per_band", t) == pytest.approx(1.5)
    assert read("serve.edge_idle_ms_per_req", t) == pytest.approx(4.0)
    assert read("serve.launches_per_band", t) == 3.0


def test_training_readers():
    t = made_up(spans.MAP, spans.STEP)
    assert read("train.step_idle_ms_per_step", t) == pytest.approx(1.5)
    assert read("train.edge_idle_ms_per_epoch", t) == pytest.approx(4.0)
    assert read("train.edge_idle_ms_per_epoch", t,
                epochs=2) == pytest.approx(2.0)
    assert read("train.launches_per_step", t) == 3.0


@pytest.mark.parametrize("stall,band,edge", [
    ((3 * MS, 3500000), 1.25, 4.0),      # half of the first band's gap
    ((17 * MS, 18 * MS), 1.5, 3.0),      # a third of the last edge gap
    ((5 * MS, 6 * MS), 1.5, 4.0)])       # the device is busy: nothing
def test_idle_in_profiler_operations_is_left_out(stall, band, edge):
    t = made_up(spans.MAP, spans.BAND, stall)
    assert read("serve.band_idle_ms_per_band", t) == pytest.approx(band)
    assert read("serve.edge_idle_ms_per_req", t) == pytest.approx(edge)


@pytest.mark.parametrize("names,per,edge,count", [
    (("fullscene.map", "fullscene.band"), SERVE[0], SERVE[1], 2),
    (("fullscene.map", "trainer.step"), TRAIN[0], TRAIN[1], 2)])
@pytest.mark.parametrize("stall", [None, (3 * MS, 3500000),
                                   (17 * MS, 18 * MS)])
def test_the_idle_metrics_add_up_to_the_idle_time(names, per, edge, count,
                                                  stall):
    t = made_up(*names, stall)
    total = read(per, t) * count + read(edge, t)
    assert total == pytest.approx(1e3 * (t.window_s - t.busy_s))


def test_launches_are_counted_by_host_start_on_any_thread():
    t = made_up(spans.MAP, spans.BAND)
    bands = spans.intervals(t, spans.BAND)
    assert bands == [(2 * MS, 8 * MS), (8 * MS, 14 * MS)]
    # ending after its band, the 5 ms launch counts in the first; the one
    # at 8 ms in the second only; the one before the span in none
    assert spans.launches(t, bands[:1]) == 3
    assert spans.launches(t, bands[1:]) == 3
    assert spans.launches(t, [(0, 20 * MS)]) == 7


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_nothing_to_read_without_the_ranges(name):
    bare = Trace([("k", 0, 3 * MS)], [("gpubench.traced", 0, 20 * MS),
                                      ("cudaLaunchKernel", 1, 2)],
                 0, 20 * MS)
    assert read(name, bare) is None
    # with the ranges but no device activity (a CPU run): nothing
    host = made_up(spans.MAP, spans.BAND).host_ops + \
        made_up(spans.MAP, spans.STEP).host_ops
    assert read(name, Trace([], host, 0, 20 * MS)) is None
