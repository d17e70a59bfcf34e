"""The plain versions behind the tuning sweep's variant kernels (the CPU
path of vit_cnn_tpu_torch.ops.scan_variants and .heads_variants) against
the JAX package's probes and kernels, on the same numpy inputs:

* V1 (the grid of K1's own kernel template) against ``perf/scan_sweep.py``
  ``scan_lanemajor`` (bb 8, time chunk 4), forward and reverse, and V2
  (batch-major I/O) against ``perf/scan_bm_sweep.py`` ``scan_bm`` (block_b
  8), both Pallas kernels in interpret mode, loaded by path (the probes
  are scripts, not modules of the package). (b, L, d, n) = (16, 9, 8, 4).
* V3 (tensor cores) and V4 (outer products) against
  ``vit_cnn_tpu.ops.attention.attention_reference_heads`` and the Pallas
  ``fused_attention_heads`` in interpret mode, residual off, at 4 heads of
  4 and 2 heads of 16 over 9 tokens. The attention probes run their
  benchmark when imported, so they are not loaded.

And the wrappers' dispatch: CPU tensors take the plain version and launch
nothing (V2 at the edges of its design, V3 at each form the card would
launch); inputs that require a gradient, V3 in float32 and shapes outside
a kernel's limits raise on any device. K1's launch plan is an instance of
V1's grid at the flagship's shapes, and V3's and V4's limits take every
shape their first designs took.

Tolerances: the scans rtol 1e-5 (atol 1e-6 for entries near zero; the
same float32 recurrence, another summation order); V4 in float32 the JAX
suite's op tolerance, rtol 2e-4 / atol 2e-5; V3 takes bf16, so it is held
to the float32 result on the same bf16 values within the output's bf16
rounding (rtol 2^-8, atol 1e-6).
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_cnn_tpu.ops import attention as jax_attention
from vit_cnn_tpu_torch.ops import _build
from vit_cnn_tpu_torch.ops.attention import SMEM_LIMIT
from vit_cnn_tpu_torch.ops.heads_variants import (MAX_C, MAX_N,
                                                  heads_attention_mma,
                                                  heads_attention_outer,
                                                  mma_smem, outer_smem)
from vit_cnn_tpu_torch.ops.scan_variants import (
    TILE_CHUNKS, TILE_ROWS, k1_instance, selective_scan_batch_major,
    selective_scan_batch_major_reference, selective_scan_tiled)
from vit_cnn_tpu_torch.ops.selective_scan import (SCAN_CHUNK, SCAN_ROWS,
                                                  scan_tile)

PERF = os.path.join(os.path.dirname(__file__), os.pardir, "perf")
SCAN_TOL = dict(rtol=1e-5, atol=1e-6)
ATT_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_TOL = dict(rtol=2.0 ** -8, atol=1e-6)
Bq, L, D, N = 16, 9, 8, 4
HEADS = [(4, 4), (2, 16)]            # (h, hd) over 9 tokens, batch 4


def _probe(name):
    spec = importlib.util.spec_from_file_location(
        "probe_" + name, os.path.join(PERF, name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def scan_args():
    """Batch-major (b, L, d) / (b, L, n) inputs, A (d, n), D (d,)."""
    rng = np.random.RandomState(0)
    u = rng.randn(Bq, L, D).astype(np.float32)
    dt = (np.abs(rng.randn(Bq, L, D)) * 0.1 + 0.01).astype(np.float32)
    A = -np.exp(0.5 * rng.randn(D, N)).astype(np.float32)
    Bm = rng.randn(Bq, L, N).astype(np.float32)
    Cm = rng.randn(Bq, L, N).astype(np.float32)
    Dv = rng.randn(D).astype(np.float32)
    return u, dt, A, Bm, Cm, Dv


def _lane(x):
    """(b, L, ch) numpy -> (L, ch, b) torch"""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (1, 2, 0))))


@pytest.mark.parametrize("reverse", [False, True])
def test_v1_plain_matches_lanemajor_probe(scan_args, reverse):
    from jax.experimental.pallas import tpu as pltpu

    u, dt, A, Bm, Cm, Dv = scan_args
    probe = _probe("scan_sweep")
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(probe.scan_lanemajor(
            *map(jnp.asarray, scan_args), bb=8, tc=4, reverse=reverse))
    for rows, chunk in zip(TILE_ROWS, TILE_CHUNKS):
        got = selective_scan_tiled(
            _lane(u), _lane(dt), torch.from_numpy(A), _lane(Bm), _lane(Cm),
            torch.from_numpy(Dv), reverse=reverse, rows=rows, chunk=chunk)
        np.testing.assert_allclose(got.permute(2, 0, 1).numpy(), want,
                                   **SCAN_TOL)


def test_v2_plain_matches_batch_major_probe(scan_args):
    from jax.experimental.pallas import tpu as pltpu

    probe = _probe("scan_bm_sweep")
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(probe.scan_bm(*map(jnp.asarray, scan_args),
                                        block_b=8))
    got = selective_scan_batch_major(*map(torch.from_numpy, scan_args))
    assert got.shape == (Bq, L, D) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, **SCAN_TOL)


def _qkv(h, hd, seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(4, 9, h, hd).astype(np.float32) for _ in range(3))


def _bf16(*arrays):
    """bf16 tensors, and the same values as float32 numpy arrays."""
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    return t, [x.float().numpy() for x in t]


@pytest.mark.parametrize("h,hd", HEADS)
def test_v3_v4_plain_match_jax_reference(h, hd):
    qkv = _qkv(h, hd, 10 * h + hd)
    scale = hd ** -0.5
    want = np.asarray(jax_attention.attention_reference_heads(
        *map(jnp.asarray, qkv), scale, False))
    got = heads_attention_outer(*map(torch.from_numpy, qkv), scale)
    np.testing.assert_allclose(got.numpy(), want, **ATT_TOL)

    lo, lo32 = _bf16(*qkv)
    want = np.asarray(jax_attention.attention_reference_heads(
        *map(jnp.asarray, lo32), scale, False))
    for masked in (False, True):
        got = heads_attention_mma(*lo, scale, masked=masked)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


@pytest.mark.parametrize("h,hd", HEADS)
def test_v3_v4_plain_match_pallas_kernel_interpret(h, hd):
    """The shipped Pallas kernel (the probes' G), residual off, batch 4 in
    blocks of 3."""
    from jax.experimental.pallas import tpu as pltpu

    qkv = _qkv(h, hd, 20 * h + hd)
    lo, lo32 = _bf16(*qkv)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_attention.fused_attention_heads(
            *map(jnp.asarray, qkv), 0.3, 3, False))
        want_lo = np.asarray(jax_attention.fused_attention_heads(
            *map(jnp.asarray, lo32), 0.3, 3, False))
    got = heads_attention_outer(*map(torch.from_numpy, qkv), 0.3)
    np.testing.assert_allclose(got.numpy(), want, **ATT_TOL)
    got = heads_attention_mma(*lo, 0.3)
    np.testing.assert_allclose(got.float().numpy(), want_lo, **BF16_TOL)


def _scan_lane(seed, b=5):
    rng = np.random.RandomState(seed)
    f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    return (f(L, D, b), 0.1 * f(L, D, b).abs(), -f(D, N).exp(), f(L, N, b),
            f(L, N, b), f(D))


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    from vit_cnn_tpu_torch.ops.attention import attention_reference_heads
    from vit_cnn_tpu_torch.ops.selective_scan import selective_scan_reference

    before = dict(_build.launches)
    lane = _scan_lane(1)
    torch.testing.assert_close(selective_scan_tiled(*lane, True, 16, 8),
                               selective_scan_reference(*lane, True),
                               rtol=0, atol=0)
    bm = [x.permute(2, 0, 1) if x.dim() == 3 else x for x in lane]
    torch.testing.assert_close(selective_scan_batch_major(*bm),
                               selective_scan_batch_major_reference(*bm),
                               rtol=0, atol=0)
    q, k, v = map(torch.from_numpy, _qkv(4, 4, 2))
    want = attention_reference_heads(q, k, v, 0.5)
    torch.testing.assert_close(heads_attention_outer(q, k, v, 0.5), want,
                               rtol=0, atol=0)
    lo = [x.to(torch.bfloat16) for x in (q, k, v)]
    torch.testing.assert_close(heads_attention_mma(*lo, 0.5),
                               attention_reference_heads(*lo, 0.5),
                               rtol=0, atol=0)
    assert dict(_build.launches) == before


def test_inputs_that_require_a_gradient_raise():
    lane = list(_scan_lane(2))
    lane[0].requires_grad_()
    with pytest.raises(ValueError, match="forward only"):
        selective_scan_tiled(*lane)
    bm = [x.detach().permute(2, 0, 1) if x.dim() == 3 else x for x in lane]
    bm[3] = bm[3].clone().requires_grad_()
    with pytest.raises(ValueError, match="forward only"):
        selective_scan_batch_major(*bm)
    q, k, v = map(torch.from_numpy, _qkv(4, 4, 3))
    with pytest.raises(ValueError, match="forward only"):
        heads_attention_outer(q, k.requires_grad_(), v, 0.5)
    lo = [x.detach().to(torch.bfloat16) for x in (q, k, v)]
    with pytest.raises(ValueError, match="forward only"):
        heads_attention_mma(lo[0], lo[1], lo[2].requires_grad_(), 0.5)


def test_v3_refuses_float32():
    q, k, v = map(torch.from_numpy, _qkv(4, 4, 4))
    with pytest.raises(TypeError, match="bfloat16"):
        heads_attention_mma(q, k, v, 0.5)


@pytest.mark.parametrize("fn,n,h,hd,kwargs", [
    (heads_attention_mma, 513, 4, 4, {}),
    (heads_attention_mma, 9, 4, 3, {}),                 # hd odd
    (heads_attention_mma, 9, 2, 18, {}),                # hd > 16
    (heads_attention_mma, 9, 3, 8, {"masked": True}),   # C not a 16 multiple
    (heads_attention_mma, 9, 16, 16, {"masked": True}), # C > 128
    (heads_attention_mma, 512, 16, 16, {}),             # shared memory
    (heads_attention_outer, 9, 2, 33, {}),              # hd > 32
    (heads_attention_outer, 9, 32, 16, {}),             # C > 256
    (heads_attention_outer, 512, 16, 16, {}),           # shared memory
])
def test_attention_variants_refuse_shapes_outside_their_limits(fn, n, h, hd,
                                                               kwargs):
    q = torch.zeros((1, n, h, hd), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fn(q, q, q, 0.5, **kwargs)


def test_scan_variants_refuse_shapes_outside_their_limits():
    lane = _scan_lane(5)
    with pytest.raises(ValueError, match="V1 instances"):
        selective_scan_tiled(*lane, rows=32)
    with pytest.raises(ValueError, match="V1 instances"):
        selective_scan_tiled(*lane, chunk=27)
    b = 3
    u = torch.zeros((b, L, D))
    wide_state = torch.zeros((b, L, 17))
    with pytest.raises(ValueError, match="n <= 16"):
        selective_scan_batch_major(u, u, torch.zeros((D, 17)), wide_state,
                                   wide_state, torch.zeros(D))
    with pytest.raises(ValueError, match="shape mismatch"):
        selective_scan_batch_major(u, u, torch.zeros((D, N)),
                                   torch.zeros((b, L + 1, N)),
                                   torch.zeros((b, L + 1, N)), torch.zeros(D))


# (streams, L, d, b): the flagship's scans at serving stages 1 and 2 (6
# forward and 4 reverse streams, one band of 7,588 windows) and at the
# train batch of 1,024
K1_SHAPES = [(6, 81, 72, 7588), (4, 81, 72, 7588), (6, 49, 128, 7588),
             (4, 49, 128, 7588), (6, 81, 72, 1024), (4, 49, 128, 1024)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ns,L,d,b", K1_SHAPES)
def test_k1_plan_is_an_instance_of_v1_grid(dtype, ns, L, d, b):
    """K1 launches the (4 R, SCAN_CHUNK) instance of its template, and V1's
    grid holds it, so the sweep times K1 among its neighbours."""
    R, warps = scan_tile(ns, L, d, 16, b, dtype)
    rows, chunk = k1_instance(ns, L, d, 16, b, dtype)
    assert (rows, chunk) == (SCAN_ROWS * R, SCAN_CHUNK) and warps == 4
    assert rows in TILE_ROWS and chunk in TILE_CHUNKS
    lane = _scan_lane(7)
    torch.testing.assert_close(
        selective_scan_tiled(*lane, rows=rows, chunk=chunk),
        selective_scan_tiled(*lane), rtol=0, atol=0)


def _first_mma_smem(n, c):
    """The first V3's block: q and k as bf16 rows of c + 8, v transposed
    as rows of n + 8, n padded to a multiple of 16."""
    np_ = -(-n // 16) * 16
    return 2 * (2 * np_ * (c + 8) + c * (np_ + 8))


def test_v3_limits_take_every_shape_the_first_design_took():
    """The redesign stages q, k and v as token rows (an odd number of
    16-byte units where that fits, else rows of c rounded up to 8) and
    takes every (n, h * hd) the first design took."""
    for n in range(1, MAX_N + 1):
        for c in range(2, MAX_C + 1, 2):
            if _first_mma_smem(n, c) <= SMEM_LIMIT:
                assert mma_smem(n, c) <= SMEM_LIMIT, (n, c)
    assert mma_smem(MAX_N, MAX_C) > SMEM_LIMIT


@pytest.mark.parametrize("n,h,hd,fits", [
    (144, 16, 16, True), (145, 16, 16, False), (512, 4, 16, True),
    (512, 16, 16, False)])
def test_v3_limits_at_the_shared_memory_edge(n, h, hd, fits):
    """At C = 256 the last n whose staged row fits (144) is taken, 145
    refused; 4 heads of 16 take every n up to 512."""
    q = torch.zeros((1, n, h, hd), dtype=torch.bfloat16)
    if fits:
        assert heads_attention_mma(q, q, q, 0.5).shape == q.shape
    else:
        with pytest.raises(ValueError, match="shared memory"):
            heads_attention_mma(q, q, q, 0.5)


@pytest.mark.parametrize("B,n,h,hd,masked", [
    (3, 65, 4, 16, False),     # the card's wgmma form
    (2, 161, 4, 16, False),    # past it: the online mma.sync form
    (3, 17, 16, 4, False),     # the exact-max mma.sync form, mma_k8
    (3, 17, 16, 4, True),      # G
    (2, 9, 8, 6, True)])       # G, head windows across 8 channels
def test_v3_cpu_takes_the_plain_version_at_every_route(B, n, h, hd, masked):
    """Whatever form the card would launch, CPU tensors take the plain
    version and count no launch."""
    from vit_cnn_tpu_torch.ops.attention import attention_reference_heads

    rng = np.random.RandomState(n)
    q, k, v = (torch.from_numpy(rng.randn(B, n, h, hd).astype(np.float32))
               .bfloat16() for _ in range(3))
    before = dict(_build.launches)
    torch.testing.assert_close(
        heads_attention_mma(q, k, v, hd ** -0.5, masked),
        attention_reference_heads(q, k, v, hd ** -0.5), rtol=0, atol=0)
    assert dict(_build.launches) == before


@pytest.mark.parametrize("b,L,d,n", [(8, 17, 72, 16), (5, 3, 9, 5),
                                     (3, 9, 1, 16)])
def test_v2_cpu_takes_the_plain_version_at_its_edges(b, L, d, n):
    """V2's new edges (a ragged block of 7 sequences at d 72, odd d and
    n < 16, d = 1, L within one chunk) take the plain version on the CPU
    and count no launch."""
    rng = np.random.RandomState(d)
    f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    u, B, C = f(b, L, d), f(b, L, n), f(b, L, n)
    dt, A, D = 0.1 * f(b, L, d).abs(), -f(d, n).exp(), f(d)
    before = dict(_build.launches)
    torch.testing.assert_close(
        selective_scan_batch_major(u, dt, A, B, C, D),
        selective_scan_batch_major_reference(u, dt, A, B, C, D), rtol=0,
        atol=0)
    assert dict(_build.launches) == before


def test_v4_limits_take_every_shape_the_first_design_took():
    """The first V4 took n <= 512, h * hd <= 256 and K and V of a row in
    float32 (8 n C bytes) within a block; the redesign stages the same
    float32 rows, each padded to 16 bytes, and takes the same shapes."""
    for n in range(1, MAX_N + 1):
        for c in range(1, MAX_C + 1):
            first = 8 * n * c <= SMEM_LIMIT
            assert (outer_smem(n, c) <= SMEM_LIMIT) == first, (n, c)
    assert outer_smem(MAX_N, MAX_C) > SMEM_LIMIT


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,h,hd,fits", [
    (512, 16, 16, False), (512, 8, 32, False), (113, 16, 16, True),
    (114, 8, 32, False)])
def test_v4_limits_at_the_shared_memory_edge(dtype, n, h, hd, fits):
    """n = 512 at h * hd = 256 stays refused in both dtypes; the first
    design's largest n at width 256 (113) is taken, 114 refused."""
    q = torch.zeros((1, n, h, hd), dtype=dtype)
    if fits:
        assert heads_attention_outer(q, q, q, 0.5).shape == q.shape
    else:
        with pytest.raises(ValueError, match="shared memory"):
            heads_attention_outer(q, q, q, 0.5)
