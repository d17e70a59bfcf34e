"""The port's measurement scripts (vit_cnn_tpu_torch.tools) on the CPU, at
a tiny Synthetic scene: 24 x 40, 20 bands, 6 classes.

The conditioning script's CPU pair (default threads against one thread)
must run and report a spread; on this tiny step it stays below 1e-3 of
each gradient's scale. The profiler's family names must sort the kernel
names the profile meets, and the ablation tool must read each kernel's
registers, spills and shared memory from ``-Xptxas -v``.
"""

import json

import pytest
import torch

from vit_cnn_tpu_torch import tools
from vit_cnn_tpu_torch.tools import (kernel_ablation, profile_train,
                                     train_conditioning)

TINY = {"VCT_SYN_H": "24", "VCT_SYN_W": "40", "VCT_SYN_BANDS": "20",
        "VCT_SYN_CLASSES": "6"}


@pytest.fixture
def tiny_scene(monkeypatch):
    for k, v in TINY.items():
        monkeypatch.setitem(tools.SCENE, k, v)
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(train_conditioning, "BATCH", 8)


def test_train_conditioning_cpu(tiny_scene, capsys):
    train_conditioning.main()
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert lines[0]["losses"]["cpu"] == pytest.approx(
        lines[0]["losses"]["cpu 1 thread"], rel=1e-5)
    (pair,) = lines[1:]
    assert pair["pair"] == "cpu 1 thread vs cpu"
    assert pair["gradients"] > 50
    assert pair["max_rel"] < 1e-3 and pair["norm_rel"] < 1e-3


def test_flagship_step_cpu(tiny_scene):
    scene = tools.load_scene(crop=(20, 30))
    assert scene[0].shape == (20, 30, 20) and scene[2].shape == (20, 30)
    trainer, args = tools.train_step(scene, tools.model_state(scene),
                                     "cpu", 4, flip=True)
    before = {k: p.detach().clone() for k, p in
              trainer.model.named_parameters()}
    loss = trainer._step(*args)
    assert torch.isfinite(loss)
    moved = [k for k, p in trainer.model.named_parameters()
             if not torch.equal(p, before[k])]
    assert len(moved) == len(before)


@pytest.mark.parametrize("kernel,family", [
    ("selective_scan_bwd_kernel<16>", "K5 scan backward"),
    ("selective_scan_kernel<float>", "K1 scan forward"),
    ("selective_scan_fwd_kernel<__nv_bfloat16, 4, true>", "K1 scan forward"),
    ("dir_conv_silu_kernel<__nv_bfloat16, 4>", "K2 dir_conv forward"),
    ("dir_conv_silu_bwd_kernel", "K6 dir_conv backward"),
    ("inv_perm_weighted_sum_bwd_kernel", "K7 inv-sum backward"),
    ("sum_partials_kernel", "K5-K7 partial sums"),
    ("sum_quads_kernel<__nv_bfloat16>", "K5-K7 partial sums"),
    ("nvjet_tst_128x64", "GEMM"),
    ("void at::native::vectorized_elementwise_kernel<4>", "elementwise/copy/cast"),
    ("multi_tensor_apply_kernel", "optimizer"),
    ("heads_kernel<__nv_bfloat16, 16>", "K8 heads attention"),
    ("pooled_kernel<__nv_bfloat16, 4>", "K9 pooled attention"),
    ("attention_kernel<__nv_bfloat16>", "K4 attention forward"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_ndhwc", "conv"),
    ("(anonymous namespace)::dir_conv_silu_bwd_kernel<__nv_bfloat16, 4, "
     "true>(__nv_bfloat16 const*, float const*)", "K6 dir_conv backward"),
    ("(anonymous namespace)::inv_perm_weighted_sum_bwd_kernel<__nv_bfloat16, "
     "8, 6, 4>(__nv_bfloat16 const*)", "K7 inv-sum backward"),
    ("(anonymous namespace)::sum_partials_rows_kernel(float const*, float*, "
     "long long)", "K5-K7 partial sums"),
])
def test_profile_families(kernel, family):
    assert profile_train.family(kernel) == family


PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125selective_scan_fwd\
_kernelI13__nv_bfloat16Li2ELb1EEEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_125selective_scan_fwd\
_kernelI13__nv_bfloat16Li2ELb1EEEvPKT_
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 41984 bytes smem, 456 \
bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120sum_partials\
_kernelIfEEvPKfPT_iix' for 'sm_90a'
ptxas info    : Used 12 registers, 384 bytes cmem[0]
"""


def test_kernel_ablation_reads_ptxas_usage():
    name = ("_ZN12_GLOBAL__N_125selective_scan_fwd_kernelI13__nv_bfloat16"
            "Li2ELb1EEEvPKT_")
    assert kernel_ablation.ptxas_usage(
        PTXAS, "selective_scan_fwd_kernel") == {name: dict(
            spill_stores=8, spill_loads=4, registers=96, smem=41984)}
    assert kernel_ablation.ptxas_usage(PTXAS, "dir_conv_silu_kernel") == {}


@pytest.mark.parametrize("argv", [["scan", "a.cu"], ["conv", "a.cu", "b.cu"],
                                  ["scan_bwd", "old/a.cu", "a.cu"],
                                  ["sum", "old/dirstream.cu", "dirstream.cu"],
                                  ["attn", "attention.cu"],
                                  ["conv_bwd", "old/dirstream_bwd.cu",
                                   "dirstream_bwd.cu"],
                                  ["sum_bwd", "dirstream_bwd.cu"],
                                  ["scan_bm", "old/scan_variants.cu",
                                   "scan_variants.cu"],
                                  ["mma", "old/heads_variants.cu",
                                   "heads_variants.cu"]])
def test_kernel_ablation_parses_kind_and_sources(argv):
    kind, srcs = kernel_ablation.parse_args(argv)
    assert kind == argv[0]
    assert [p.name for p in srcs] == [a.split("/")[-1] for a in argv[1:]]
    assert all(p.is_absolute() for p in srcs)


@pytest.mark.parametrize("argv", [[], ["scan_bwd"], ["bwd", "a.cu"],
                                  ["attn"], ["inv_sum", "a.cu"],
                                  ["conv_bwd"], ["sum_bwd"], ["scan_bm"],
                                  ["mma"], ["wgmma", "a.cu"]])
def test_kernel_ablation_refuses_other_arguments(argv):
    with pytest.raises(SystemExit, match=(
            r"scan\|conv\|sum\|attn\|scan_bwd\|conv_bwd\|sum_bwd A.cu")):
        kernel_ablation.parse_args(argv)


@pytest.mark.parametrize("kind,entry,kernels", [
    ("scan_bm", "vct_selective_scan_batch_major",
     ["scan_batch_major_kernel"]),
    ("mma", "vct_heads_attention_mma",
     ["heads_mma_kernel", "heads_wgmma_kernel"])])
def test_kernel_ablation_variant_cases_are_the_sweeps(kind, entry, kernels):
    """V2's cases are tools/scan_sweep.py's forward cases (the batch-major
    layout has no reverse), V3's the attention sweep's four shapes in bf16
    only; each names its C entry point, and the ptxas filter takes every
    kernel of its source (V3: the mma.sync and the wgmma forms)."""
    from vit_cnn_tpu_torch.ops import _build
    from vit_cnn_tpu_torch.tools import heads_attn_variants, scan_sweep

    cases, run_case = kernel_ablation.CASES[kind]
    if kind == "scan_bm":
        assert cases == tuple(c[:5] for c in scan_sweep.CASES if not c[5])
        assert len(cases) == 4 and kind not in kernel_ablation.BF16_ONLY
    else:
        assert cases == heads_attn_variants.SHAPES
        assert kind in kernel_ablation.BF16_ONLY
    assert run_case is getattr(kernel_ablation, kind + "_case")
    got_entry, kernel = kernel_ablation.KINDS[kind]
    assert got_entry == entry and entry in _build._SIGNATURES
    assert all(kernel in name for name in kernels)


def test_kernel_ablation_scan_bwd_cases_are_the_train_launches():
    """K5's cases are its four launches per train step: stage 1 (81
    tokens, d 72) and stage 2 (49, 128), 6 forward and 4 reverse streams
    each, batch 1024, run through the C entry point and its workspace."""
    from vit_cnn_tpu_torch.ops import _build

    got = sorted(case[1:] for case in kernel_ablation.SCAN_BWD_CASES)
    want = sorted((ns, L, d, 1024, rev) for L, d in ((81, 72), (49, 128))
                  for ns, rev in ((6, False), (4, True)))
    assert got == want
    entry, kernel = kernel_ablation.KINDS["scan_bwd"]
    assert entry in _build._SIGNATURES
    assert entry + "_workspace" in _build._WORKSPACE_SIGNATURES
    assert kernel_ablation.CASES["scan_bwd"] == (
        kernel_ablation.SCAN_BWD_CASES, kernel_ablation.scan_bwd_case)


@pytest.mark.parametrize("kind,family", [
    ("conv_bwd", "K6 dir_conv backward"), ("sum_bwd", "K7 inv-sum backward")])
def test_kernel_ablation_dirstream_adjoint_cases_are_the_train_launches(
        kind, family):
    """K6's and K7's cases are their two launches per train step: stage 1
    (81 tokens, d 72) and stage 2 (49, 128) at batch 1024, each with 6
    forward and 4 reverse streams, run through the C entry point and its
    workspace; their kernels file under their own profile rows."""
    from vit_cnn_tpu_torch.ops import _build

    cases, run_case = kernel_ablation.CASES[kind]
    assert cases == (("train stage 1", 81, 72, 1024),
                     ("train stage 2", 49, 128, 1024))
    assert run_case is getattr(kernel_ablation, kind + "_case")
    entry, kernel = kernel_ablation.KINDS[kind]
    assert entry in _build._SIGNATURES
    assert entry + "_workspace" in _build._WORKSPACE_SIGNATURES
    assert profile_train.family(kernel) == family


def test_kernel_ablation_holds_adjoints_elementwise_and_sums_by_scale():
    """An adjoint's leading outputs (K6's du, K7's dy) are held elementwise,
    its summed gradients against their largest entry."""
    want = (torch.tensor([1000.0, 1e-3]), torch.tensor([1000.0, 1e-3]))
    near = (want[0], torch.tensor([1000.05, 0.05]))
    err, ok = kernel_ablation.compare_grads(near, want, "float32", plain=1)
    assert ok and err == pytest.approx(0.05, abs=1e-3)
    off = (torch.tensor([1000.0, 0.05]), want[1])
    assert not kernel_ablation.compare_grads(off, want, "float32", plain=1)[1]
    assert kernel_ablation.compare_grads(off, want, "float32", plain=0)[1]


def test_kernel_ablation_sum_cases_are_the_main_path_launches():
    """K3's cases are its launches on the flagship's paths: serving stages
    1 (81 tokens, d 72) and 2 (49, 128) at a band of 7,588 windows and
    train stage 1 at batch 1024, through the C entry point."""
    from vit_cnn_tpu_torch.ops import _build

    assert kernel_ablation.SUM_CASES == (
        ("stage 1", 81, 72, 7588), ("stage 2", 49, 128, 7588),
        ("train stage 1", 81, 72, 1024))
    entry, kernel = kernel_ablation.KINDS["sum"]
    assert entry == "vct_inv_perm_weighted_sum"
    assert entry in _build._SIGNATURES
    assert profile_train.family(kernel) == "K3 inv-sum forward"
    assert kernel_ablation.CASES["sum"] == (kernel_ablation.SUM_CASES,
                                            kernel_ablation.sum_case)


def test_kernel_ablation_attn_cases_are_the_main_path_launches():
    """K4's cases are the NonLocal blocks' launches: (Lq, Lk, dh) = (49,
    9, 128) and (25, 4, 72) over a band of 7,588 windows, and (49, 9, 128)
    at train batch 1024."""
    from vit_cnn_tpu_torch.ops import _build

    assert kernel_ablation.ATTN_CASES == (
        ("stage 1", 7588, 49, 9, 128), ("stage 2", 7588, 25, 4, 72),
        ("train stage 1", 1024, 49, 9, 128))
    entry, kernel = kernel_ablation.KINDS["attn"]
    assert entry == "vct_attention"
    assert entry in _build._SIGNATURES
    assert kernel_ablation.CASES["attn"] == (kernel_ablation.ATTN_CASES,
                                             kernel_ablation.attn_case)


@pytest.mark.parametrize("kernel,family", [
    ("inv_perm_weighted_sum_kernel<__nv_bfloat16, 8, 6, 4>",
     "K3 inv-sum forward"),
    ("attention_tile_kernel<__nv_bfloat16, 9>", "K4 attention forward"),
])
def test_profile_families_of_the_redesigned_kernels(kernel, family):
    assert profile_train.family(kernel) == family


def test_kernel_ablation_holds_sums_to_their_largest_entry():
    """K5's outputs are held to atol + rtol * max|want| per output, so an
    entry near zero may keep the rounding of the large terms it sums."""
    want = (torch.tensor([1000.0, 1e-3]), torch.tensor([2.0, -2.0]))
    near = (torch.tensor([1000.05, 0.05]), torch.tensor([2.0, -2.0]))
    err, ok = kernel_ablation.compare_summed(near, want, "float32")
    assert ok and err == pytest.approx(0.05, abs=1e-3)
    far = (near[0], torch.tensor([2.0, -1.99]))
    assert not kernel_ablation.compare_summed(far, want, "float32")[1]
    nan = (torch.tensor([1000.0, float("nan")]), want[1])
    assert not kernel_ablation.compare_summed(nan, want, "float32")[1]
