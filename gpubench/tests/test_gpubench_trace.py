"""The trace reduction and the per-layer readers on a made-up trace."""

import pytest

from gpubench import layout
from gpubench.trace import Trace, family

MS = 1_000_000      # ns


def made_up():
    device = [("void (anonymous namespace)::selective_scan_fwd_kernel<bf16>",
               0, 4 * MS),
              ("vectorized_elementwise_kernel<4, CUDAFunctor_add>", 3 * MS,
               6 * MS),
              ("cudnn::implicit_convolve_sgemm", 8 * MS, 9 * MS),
              ("multi_tensor_apply_kernel<AdamFunctor>", 9 * MS, 10 * MS),
              ("outside", 20 * MS, 30 * MS)]
    host = [("gpubench.traced", 0, 10 * MS), ("aten::to", 6 * MS, 8 * MS),
            ("cudaMemcpyAsync", 6500000, 7500000)]
    return Trace(device, host, 0, 10 * MS)


def test_busy_gaps_and_families():
    t = made_up()
    assert t.window_s == pytest.approx(0.010)
    assert t.busy_s == pytest.approx(0.008)          # 0-6 and 8-10 ms
    assert t.gaps() == [(6 * MS, 8 * MS)]
    assert t.idle_gaps() == [["cudaMemcpyAsync", pytest.approx(0.002)]]
    fams = t.family_seconds()
    assert fams["K1 scan forward"] == pytest.approx(0.004)
    assert fams["elementwise/copy/cast"] == pytest.approx(0.003)
    assert fams["conv"] == pytest.approx(0.001)
    assert fams["optimizer"] == pytest.approx(0.001)
    assert t.top_ops(1)[0][1] == pytest.approx(0.004)


def test_library_attention_is_not_a_port_kernel():
    assert family("fmha_cutlassF_bf16_aligned_64x64_rf_sm80(AttentionKernel"
                  "<bf16>::Params)") != "K4 attention forward"
    assert family("attention_tile_kernel<bf16>") == "K4 attention forward"
    assert family("pytorch_flash::flash_fwd_kernel") != \
        "K4 attention forward"


def test_readers():
    t = made_up()
    counts = layout.module("counts", "mamba-h13")
    work = {"traced": {"windows": 1000, "bands": 1, "computed_windows": 1000,
                       "steps": 2, "valid_patches": 10, "patches": 16}}
    ctx = {"trace": t, "counts": counts, "work": work}
    read = lambda name: layout.module("metrics", name).read(ctx)
    assert read("serve.idle_pct") == pytest.approx(20.0)
    assert read("serve.k1_roofline") == pytest.approx(
        100 * counts.K1_LEAST_S_PER_BAND / 0.004)
    assert read("serve.mfu") == pytest.approx(
        100 * counts.FLOPS_PER_WINDOW * 1000 / 0.010 / 989e12)
    assert read("serve.eltwise_ms_per_kwin") == pytest.approx(3.0)
    assert read("train.optimizer_ms_per_step") == pytest.approx(0.5)
    # counts without the number, or no kernel of the family: nothing
    assert read("serve.conv_roofline") is None
    assert read("train.mfu") is None
    empty = Trace([], [], 0, MS)
    assert layout.module("metrics", "serve.idle_pct").read(
        dict(ctx, trace=empty)) is None
    assert layout.module("metrics", "serve.k1_roofline").read(
        dict(ctx, trace=empty)) is None


def test_profiler_stalls_leave_the_window():
    """Device idle time while the host is in the profiler's own buffer
    request is the tracer's: it leaves ``window_s``, and so the idle
    share; idle time outside it stays."""
    device = [("k", 0, 4 * MS), ("k", 6 * MS, 10 * MS)]
    host = [("gpubench.traced", 0, 10 * MS),
            ("Activity Buffer Request", 3 * MS, 5 * MS)]
    t = Trace(device, host, 0, 10 * MS)
    assert t.busy_s == pytest.approx(0.008)
    assert t.window_s == pytest.approx(0.009)        # 4-5 ms left out
    idle = layout.module("metrics", "train.idle_pct").read(
        {"trace": t, "counts": None, "work": {}})
    assert idle == pytest.approx(100 * (1 - 8 / 9))
