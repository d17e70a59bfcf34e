"""The port's CUDA kernels against their plain PyTorch versions on the card,
at edge shapes the flagship's paths do not reach: sequence lengths that
are no multiple of the staging chunk, odd channel counts, a state size
below 16, no reverse streams, a batch of one, orders that need more than
48 KB of shared memory, attention at its Lk / dh limits, and more groups
than one grid holds. The adjoint kernels (K5-K7) are held against
autograd through the plain forwards, every autograd Function's gradients
against autograd through its plain version, and the summed gradients
must be bitwise equal from one launch to the next. The head-last
attention kernels (K8, K9) are held at one token, 17 tokens (a last key
tile that is mostly padding), the zoo's token counts, the 512-token limit
(in bf16 with the heads split over blocks), head widths 4 / 5 / 12 / 16 /
24 / 32, ragged batches and the strided q / k / v views of a fused
projection; K8's bf16 instance also against its float32 instance; both
under autograd at the zoo's train shapes (batch 1024: K8 at 65, 145 and
146 tokens on a fused qkv's views, K9 at MHST's 65 tokens). K1 and
K2 at the edges of their tiles: b = 1, 31, 33, 7,588; d = 1, 5, 72, 128;
n = 1, 7, 16; L = 1, 2, 3, 81; k = 1, 4, 8; forward and reverse; and
K1's tile as the C entry point plans it equal to ``scan_tile``. K2, K3,
K6 and K7 at the shuffle paths' stream counts (nb, nr) = (1, 0), (2, 1),
(3, 1) with an order row drawn anew on every call, and the Mamba layer of
every path kind and the batch-major MambaMixer against the CPU with their
launch counts. The tuning
sweep's variants: every instance of the grid of K1's kernel template
(V1) against the plain scan, and its instance at K1's plan equal to K1
bit for bit, the batch-major scan (V2) at ragged batches and at the
edges of its design (d 1 / 9 / 1,024, n below 16, L below and past its
staging chunk, offset views), and the tensor-core (V3, bf16) and
outer-product (V4) head-last attention at one token, 65 and 146 tokens,
head widths 4 and 16 and ragged batches; V3 also at head widths 2 / 4 /
6 / 16, C = 256, 17, 160 and 161 tokens (either side of its wgmma form's
limit) and the largest n its shared memory takes, and on misaligned
inputs; V4 also at head widths 1 / 3 / 4 / 5 / 16 / 17 / 32 up to the
largest n its shared memory takes, and on misaligned inputs.
chip_smoke.py covers the serving and training shapes.

These tests need a CUDA card and skip without one. On the GPU host:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

(``--noconftest``: tests/conftest.py sets up jax for the CPU suite; these
tests need only torch.)

Tolerances: float32 rtol 1e-4 / atol 1e-5 (the kernels sum in another
order than torch); bfloat16 rtol 2e-2 / atol 2e-2 (both sides compute in
float32 and round once to bf16, so they differ by at most one bf16 step).
A gradient summed over batch and time (dA, dD, dcw, dcb, dw) takes its
relative term against the tensor's largest magnitude: both sides add up
to a few hundred thousand float32 terms in different orders, so an entry
that cancels to near zero keeps the absolute error of the large ones.
So does every output of K5: each is a sum (over the state, the channels
or the time steps) whose terms cancel, and K5 takes its exps with the
fast ``__expf`` (~2e-6 relative error) where torch's are exact to an ulp.
"""

import numpy as np
import pytest
import torch

from vit_cnn_tpu_torch.ops import _build
from vit_cnn_tpu_torch.ops.attention import (
    attention_reference, attention_reference_heads, fused_attention,
    fused_attention_heads, pooled_attention_reference,
    pooled_heads_attention)
from vit_cnn_tpu_torch.ops.dirstream import (
    dir_conv_silu, dir_conv_silu_backward,
    dir_conv_silu_backward_reference, dir_conv_silu_reference,
    inv_perm_weighted_sum, inv_perm_weighted_sum_backward,
    inv_perm_weighted_sum_backward_reference,
    inv_perm_weighted_sum_reference)
from vit_cnn_tpu_torch.ops.attention import SMEM_LIMIT
from vit_cnn_tpu_torch.ops.heads_variants import (MAX_N,
                                                  heads_attention_mma,
                                                  heads_attention_outer,
                                                  mma_smem, outer_smem)
from vit_cnn_tpu_torch.ops.scan_variants import (
    TILE_CHUNKS, TILE_ROWS, k1_instance, selective_scan_batch_major,
    selective_scan_batch_major_reference, selective_scan_tiled)
from vit_cnn_tpu_torch.ops.selective_scan import (
    scan_tile, selective_scan, selective_scan_backward,
    selective_scan_backward_reference, selective_scan_reference)

pytestmark = pytest.mark.cuda
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, want, dtype):
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype and g.shape == w.shape
        torch.testing.assert_close(g.float(), w.float(), **TOL[dtype])


def _close_summed(got, want, dtype):
    """A gradient that is a sum of cancelling terms: relative to its
    largest magnitude."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if not want.numel():
        return
    tol = TOL[dtype]
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=tol["atol"] + tol["rtol"] * scale)


def _randn(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lead,L,d,n,b,reverse", [
    ((), 9, 5, 16, 33, False), ((2,), 13, 9, 4, 1, True),
    ((3,), 81, 72, 16, 130, True), ((2,), 1, 8, 16, 7, False)])
def test_selective_scan(gen, dtype, lead, L, d, n, b, reverse):
    u = _randn(gen, *lead, L, d, b).to(dtype)
    dt = torch.nn.functional.softplus(_randn(gen, *lead, L, d, b) - 2).to(
        dtype)
    B, C = (_randn(gen, *lead, L, n, b).to(dtype) for _ in range(2))
    A = -torch.exp(_randn(gen, d, n))
    D = _randn(gen, d)
    before = _build.launches["selective_scan"]
    got = selective_scan(u, dt, A, B, C, D, reverse=reverse)
    assert _build.launches["selective_scan"] == before + 1
    _close(got, selective_scan_reference(u, dt, A, B, C, D, reverse), dtype)


EDGE_B = [1, 31, 33, 7588]
EDGE_D = [1, 5, 72, 128]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", EDGE_B)
@pytest.mark.parametrize("d", EDGE_D)
def test_selective_scan_tile_edges(gen, dtype, b, d):
    """K1 at the edges of its tiles: ragged b and d, n below 16, one to
    three tokens, forward and reverse, one and several streams."""
    for lead, L, n, reverse in [((), 1, 1, False), ((2,), 2, 7, True),
                                ((3,), 3, 16, False), ((), 81, 16, True),
                                ((2,), 81, 7, False)]:
        args = _scan_args(gen, lead, L, d, n, b, dtype)
        before = _build.launches["selective_scan"]
        got = selective_scan(*args, reverse=reverse)
        assert _build.launches["selective_scan"] == before + 1
        _close(got, selective_scan_reference(*args, reverse), dtype)


def test_c_tile_plan_equals_scan_tile(gen):
    lib = _build.lib()
    for ns in (1, 2, 4, 6, 10):
        for d in (1, 2, 3, 5, 9, 17, 52, 72, 100, 128, 255, 256):
            for b in (1, 33, 1001, 1024, 7588, 40960):
                for dtype in DTYPES:
                    R = scan_tile(ns, 81, d, 16, b, dtype)[0]
                    assert lib.vct_selective_scan_tile(
                        _build.dtype_code(torch.empty(0, dtype=dtype)), ns,
                        81, d, 16, b) == R, (dtype, ns, d, b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", EDGE_B)
@pytest.mark.parametrize("d", EDGE_D)
def test_dir_conv_silu_edges(gen, dtype, b, d):
    """K2 at the edges of its tile: ragged b (odd b stores pairs that are
    not aligned one value at a time) and d, one to three tokens, 1, 4 and
    8 taps, with and without reverse streams."""
    for L, k, nb, rev_rows in [(1, 1, 1, (0,)), (2, 4, 2, (1,)),
                               (3, 8, 3, (0, 2)), (81, 4, 6, (0, 1, 2, 3)),
                               (81, 8, 2, ()), (81, 1, 3, (2,))]:
        orders, _ = _orders(L, nb, L + k)
        rr = torch.tensor(rev_rows, dtype=torch.int32, device="cuda")
        u = _randn(gen, L, d, b).to(dtype)
        cw, cb = 0.5 * _randn(gen, k, d), 0.1 * _randn(gen, d)
        before = _build.launches["dir_conv_silu"]
        got = dir_conv_silu(u, cw, cb, orders, rr)
        assert _build.launches["dir_conv_silu"] == before + 1
        _close(got, dir_conv_silu_reference(u, cw, cb, orders, rr), dtype)


def _orders(L, nb, seed):
    rng = np.random.RandomState(seed)
    orders = np.stack([rng.permutation(L) for _ in range(nb)])
    inv = np.argsort(orders, axis=1)
    i32 = dict(dtype=torch.int32, device="cuda")
    return torch.tensor(orders, **i32), torch.tensor(inv, **i32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L,d,b,nb,rev_rows,k", [
    (9, 5, 37, 3, (0, 2), 4), (81, 72, 64, 6, (0, 1, 2, 3), 4),
    (200, 3, 40, 2, (1,), 2), (16, 8, 1, 2, (), 3)])
def test_dir_conv_silu_and_inverse_sum(gen, dtype, L, d, b, nb, rev_rows, k):
    orders, inv = _orders(L, nb, L)
    rr = torch.tensor(rev_rows, dtype=torch.int32, device="cuda")
    u = _randn(gen, L, d, b).to(dtype)
    cw, cb = 0.5 * _randn(gen, k, d), 0.1 * _randn(gen, d)
    got = dir_conv_silu(u, cw, cb, orders, rr)
    _close(got, dir_conv_silu_reference(u, cw, cb, orders, rr), dtype)
    yf, yr = got
    wf = torch.softmax(_randn(gen, nb), 0)
    wr = torch.softmax(_randn(gen, len(rev_rows) + 1), 0)[:len(rev_rows)]
    _close(inv_perm_weighted_sum(yf, yr, wf, wr, inv, rr),
           inv_perm_weighted_sum_reference(yf, yr, wf, wr, inv, rr), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("G,lq,lk,dh,scale", [
    (3, 5, 64, 256, 0.0625), (70000, 2, 3, 8, 1.0), (17, 49, 9, 128, 1.0),
    (5, 1, 1, 33, 0.5)])
def test_attention(gen, dtype, G, lq, lk, dh, scale):
    q, k, v = (0.5 * _randn(gen, G, n, dh) for n in (lq, lk, lk))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    _close(fused_attention(q, k, v, scale),
           attention_reference(q, k, v, scale), dtype)


# K3's dispatch: planes of d * b values, 16 bytes a thread where every
# plane starts 16-byte aligned (d * b a multiple of 8 in bf16, 4 in
# float32), one value a thread elsewhere; the main path's 6 + 4 streams
# fixed at compile time, other counts read at run time
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [1, 3, 4, 1024, 7588])
def test_inverse_sum_edges(gen, dtype, b):
    """K3 at one token, ragged and aligned planes, no reverse streams and
    stream counts other than 6 + 4."""
    for L, d, nb, rev_rows in [(1, 3, 6, (0, 1, 2, 3)),
                               (81, 72, 6, (0, 1, 2, 3)),
                               (49, 5, 3, (0, 2)), (9, 8, 2, (1,)),
                               (4, 7, 2, ())]:
        _, inv = _orders(L, nb, L + b)
        rr = torch.tensor(rev_rows, dtype=torch.int32, device="cuda")
        nr = len(rev_rows)
        yf = _randn(gen, nb, L, d, b).to(dtype)
        yr = _randn(gen, nr, L, d, b).to(dtype)
        w = torch.softmax(_randn(gen, nb + nr), 0)
        wf, wr = w[:nb], w[nb:]
        before = _build.launches["inv_perm_weighted_sum"]
        got = inv_perm_weighted_sum(yf, yr, wf, wr, inv, rr)
        assert _build.launches["inv_perm_weighted_sum"] == before + 1
        _close(got, inv_perm_weighted_sum_reference(yf, yr, wf, wr, inv, rr),
               dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nb,rev_rows", [(6, (0, 1, 2, 3)), (3, (1,))])
def test_inverse_sum_misaligned_views(gen, dtype, nb, rev_rows):
    """Contiguous streams at an odd element offset of their buffer: K3
    takes one value a thread."""
    L, d, b = 9, 8, 64
    nr = len(rev_rows)
    size = L * d * b
    flat = _randn(gen, (nb + nr) * size + 1).to(dtype)
    yf = flat[1:1 + nb * size].view(nb, L, d, b)
    yr = flat[1 + nb * size:].view(nr, L, d, b)
    assert yf.data_ptr() % 16 and yr.data_ptr() % 16
    _, inv = _orders(L, nb, 3)
    rr = torch.tensor(rev_rows, dtype=torch.int32, device="cuda")
    w = torch.softmax(_randn(gen, nb + nr), 0)
    _close(inv_perm_weighted_sum(yf, yr, w[:nb], w[nb:], inv, rr),
           inv_perm_weighted_sum_reference(yf, yr, w[:nb], w[nb:], inv, rr),
           dtype)


# K4's dispatch: the tiled instance for dh % 8 == 0, Lk <= 16 and 16-byte
# aligned q, k, v (Lk 9 and 4 fixed at compile time), the one-group-a-
# block instance elsewhere; G = 7 and 15 leave the last tile of (49, 9,
# 128) and (25, 4, 72) part full
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lk", [1, 2, 4, 7, 9, 15, 16, 17, 40, 64])
@pytest.mark.parametrize("dh", [8, 33, 72, 128, 256])
def test_attention_edges(gen, dtype, lk, dh):
    for G, lq, scale in [(7, 49, 1.0), (15, 25, 0.3), (3, 1, 1.0)]:
        q, k, v = (0.5 * _randn(gen, G, n, dh) for n in (lq, lk, lk))
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        before = _build.launches["fused_attention"]
        got = fused_attention(q, k, v, scale)
        assert _build.launches["fused_attention"] == before + 1
        _close(got, attention_reference(q, k, v, scale), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lq,lk,dh", [(25, 4, 72), (2, 3, 8)])
def test_attention_beyond_one_grid(gen, dtype, lq, lk, dh):
    """70,000 groups: more than the 65,535 blocks of one grid dimension."""
    G = 70000
    q, k, v = (0.5 * _randn(gen, G, n, dh) for n in (lq, lk, lk))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    _close(fused_attention(q, k, v, 1.0), attention_reference(q, k, v, 1.0),
           dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_misaligned_views(gen, dtype):
    """q, k and v contiguous at an odd element offset of one buffer."""
    G, lq, lk, dh = 7, 49, 9, 128
    flat = (0.5 * _randn(gen, G * (lq + 2 * lk) * dh + 1)).to(dtype)
    nq, nk = G * lq * dh, G * lk * dh
    q = flat[1:1 + nq].view(G, lq, dh)
    k = flat[1 + nq:1 + nq + nk].view(G, lk, dh)
    v = flat[1 + nq + nk:].view(G, lk, dh)
    assert q.data_ptr() % 16 and k.data_ptr() % 16 and v.data_ptr() % 16
    _close(fused_attention(q, k, v, 1.0), attention_reference(q, k, v, 1.0),
           dtype)


def test_attention_keeps_p_in_float32(gen):
    """A float32 case that P rounded to bf16 before P.V fails by two
    orders of magnitude (P's relative step 2^-9 against rtol 1e-4): the
    kernel must keep P in float32, as the TPU kernel does."""
    G, lq, lk, dh = 64, 49, 9, 128
    q, k, v = (_randn(gen, G, n, dh) for n in (lq, lk, lk))
    want = attention_reference(q, k, v, 0.125)
    p = torch.softmax(torch.einsum("gid,gjd->gij", q, k) * 0.125, -1)
    rounded = torch.einsum("gij,gjd->gid", p.bfloat16().float(), v)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(rounded, want, **TOL[torch.float32])
    _close(fused_attention(q, k, v, 0.125), want, torch.float32)


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    q = _randn(gen, 2, 3, 8)
    with pytest.raises(ValueError, match="Lk <= 64"):
        fused_attention(q, _randn(gen, 2, 65, 8), _randn(gen, 2, 65, 8), 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        fused_attention(q.transpose(1, 2).contiguous().transpose(1, 2), q, q,
                        1.0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_attention(q.half(), q.half(), q.half(), 1.0)


def _scan_args(gen, lead, L, d, n, b, dtype):
    u = _randn(gen, *lead, L, d, b).to(dtype)
    dt = torch.nn.functional.softplus(_randn(gen, *lead, L, d, b) - 2).to(
        dtype)
    B, C = (_randn(gen, *lead, L, n, b).to(dtype) for _ in range(2))
    A = -torch.exp(0.5 * _randn(gen, d, n))
    D = _randn(gen, d)
    return u, dt, A, B, C, D


# K5's edges: one-step and ragged 4-step chunks (L 1, 3, 5, 49, 81) in both
# directions, channels that do not fill a block of 8 (d 5, 9, 72, 130),
# lanes that do not fill a warp (b 1, 7, 33, 1001), n 1, 5 and 16
SCAN_EDGES = [((), 9, 5, 16, 33, False), ((2,), 13, 9, 4, 1, True),
              ((3,), 81, 72, 16, 130, True), ((2,), 1, 8, 16, 7, False),
              ((4,), 49, 128, 16, 64, False), ((), 1, 5, 16, 33, False),
              ((2,), 1, 9, 5, 7, True), ((), 3, 9, 1, 1, False),
              ((2,), 3, 130, 16, 33, True), ((3,), 5, 72, 5, 7, False),
              ((2,), 5, 5, 16, 1001, True), ((2,), 49, 130, 1, 1001, True),
              ((), 49, 72, 16, 7, True), ((2,), 81, 9, 16, 1001, False),
              ((1,), 81, 5, 5, 1, True)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lead,L,d,n,b,reverse", SCAN_EDGES)
def test_selective_scan_backward(gen, dtype, lead, L, d, n, b, reverse):
    args = _scan_args(gen, lead, L, d, n, b, dtype)
    g = _randn(gen, *lead, L, d, b).to(dtype)
    before = _build.launches["selective_scan_backward"]
    got = selective_scan_backward(*args, g, reverse=reverse)
    assert _build.launches["selective_scan_backward"] == before + 1
    want = selective_scan_backward_reference(*args, g, reverse)
    for x, y in zip(got, want):
        _close_summed(x, y, dtype)


CONV_EDGES = [(9, 5, 37, 3, (0, 2), 4), (81, 72, 64, 6, (0, 1, 2, 3), 4),
              (200, 3, 40, 2, (1,), 2), (16, 8, 1, 2, (), 3),
              (49, 128, 33, 6, (0, 1, 2, 3), 4)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L,d,b,nb,rev_rows,k", CONV_EDGES)
def test_dirstream_adjoints(gen, dtype, L, d, b, nb, rev_rows, k):
    orders, inv = _orders(L, nb, L + 1)
    rr = torch.tensor(rev_rows, dtype=torch.int32, device="cuda")
    nr = len(rev_rows)
    u = _randn(gen, L, d, b).to(dtype)
    cw, cb = 0.5 * _randn(gen, k, d), 0.1 * _randn(gen, d)
    gf = _randn(gen, nb, L, d, b).to(dtype)
    gr = _randn(gen, nr, L, d, b).to(dtype)
    got = dir_conv_silu_backward(u, cw, cb, orders, rr, gf, gr)
    want = dir_conv_silu_backward_reference(u, cw, cb, orders, rr, gf, gr)
    _close(got[0], want[0], dtype)
    _close_summed(got[1], want[1], dtype)
    _close_summed(got[2], want[2], dtype)

    yf, yr = gf, gr                              # any streams will do
    wf = torch.softmax(_randn(gen, nb), 0)
    wr = torch.softmax(_randn(gen, nr + 1), 0)[:nr]
    g = _randn(gen, L, d, b).to(dtype)
    got = inv_perm_weighted_sum_backward(yf, yr, wf, wr, inv, rr, g)
    want = inv_perm_weighted_sum_backward_reference(yf, yr, wf, wr, inv, rr,
                                                    g)
    _close(got[:2], want[:2], dtype)
    _close_summed(got[2], want[2], dtype)
    _close_summed(got[3], want[3], dtype)


def _conv_adjoint_case(gen, dtype, L, d, b, nb, rev_rows, k, scale=1.0):
    orders, _ = _orders(L, nb, L + k + b)
    rr = torch.tensor(rev_rows, dtype=torch.int32, device="cuda")
    u = (scale * _randn(gen, L, d, b)).to(dtype)
    cw, cb = 0.5 * _randn(gen, k, d), 0.1 * _randn(gen, d)
    gf = _randn(gen, nb, L, d, b).to(dtype)
    gr = _randn(gen, len(rev_rows), L, d, b).to(dtype)
    return u, cw, cb, orders, rr, gf, gr


def _check_conv_adjoint(args, dtype):
    before = _build.launches["dir_conv_silu_backward"]
    got = dir_conv_silu_backward(*args)
    assert _build.launches["dir_conv_silu_backward"] == before + 1
    want = dir_conv_silu_backward_reference(*args)
    _close(got[0], want[0], dtype)
    _close_summed(got[1], want[1], dtype)
    _close_summed(got[2], want[2], dtype)


# K6's dispatch: the pair instance where b is even and every pair aligned,
# two scalar loads elsewhere; a window of 4 taps for k <= 4, 8 beyond. One
# channel and 64 sequences a block, so b = 1, 33, 65 and 1,001 leave the
# last block part empty; L = 1-3 walks fewer tokens than the window;
# rev_rows unsorted or empty; stream counts other than 6 + 4
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [1, 33, 64, 65, 1001])
@pytest.mark.parametrize("d", [1, 5, 72])
def test_dir_conv_silu_backward_edges(gen, dtype, b, d):
    for L, k, nb, rev_rows in [(1, 1, 1, (0,)), (2, 4, 2, (1,)),
                               (3, 8, 3, (2, 0)), (81, 4, 6, (0, 1, 2, 3)),
                               (49, 8, 2, ()), (9, 2, 3, (2, 0)),
                               (13, 1, 4, (3, 1, 0)), (5, 6, 5, (4, 2))]:
        _check_conv_adjoint(
            _conv_adjoint_case(gen, dtype, L, d, b, nb, rev_rows, k), dtype)


def test_dir_conv_silu_backward_fast_sigmoid_float32(gen):
    """K6 takes SiLU' with ex2.approx and __fdividef: float32 within
    ``TOL`` where the preactivations reach |z| of 25 and more at both ends
    (u x 8), so the sigmoid saturates at 0 and at 1."""
    args = _conv_adjoint_case(gen, torch.float32, 81, 72, 256, 6,
                              (0, 1, 2, 3), 4, scale=8.0)
    fwd, _ = dir_conv_silu_reference(*args[:5])
    # silu(z) = z sigmoid(z): an output above 30 needs z > 30, one of
    # magnitude below 1e-9 (and not exactly 0) needs z < -25
    assert float(fwd.max()) > 30
    assert int(((fwd.abs() < 1e-9) & (fwd != 0)).sum()) > 0
    _check_conv_adjoint(args, torch.float32)


# K7's dispatch: 16 bytes a thread where every plane starts 16-byte
# aligned (d * b a multiple of 8 in bf16, 4 in float32), one value a
# thread elsewhere; 6 + 4 streams fixed at compile time, other counts read
# at run time; up to 32 token groups, so L = 1, 40 and 81 walk one, two
# and three tokens a block
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [1, 3, 4, 1024])
def test_inverse_sum_backward_edges(gen, dtype, b):
    for L, d, nb, rev_rows in [(1, 3, 6, (0, 1, 2, 3)),
                               (81, 72, 6, (0, 1, 2, 3)),
                               (49, 5, 3, (2, 0)), (9, 8, 2, (1,)),
                               (4, 7, 2, ()), (40, 16, 8, (7, 0, 3, 5, 1))]:
        _, inv = _orders(L, nb, L + b)
        rr = torch.tensor(rev_rows, dtype=torch.int32, device="cuda")
        nr = len(rev_rows)
        yf = _randn(gen, nb, L, d, b).to(dtype)
        yr = _randn(gen, nr, L, d, b).to(dtype)
        w = torch.softmax(_randn(gen, nb + nr), 0)
        g = _randn(gen, L, d, b).to(dtype)
        before = _build.launches["inv_perm_weighted_sum_backward"]
        got = inv_perm_weighted_sum_backward(yf, yr, w[:nb], w[nb:], inv, rr,
                                             g)
        assert _build.launches["inv_perm_weighted_sum_backward"] == \
            before + 1
        want = inv_perm_weighted_sum_backward_reference(
            yf, yr, w[:nb], w[nb:], inv, rr, g)
        _close(got[:2], want[:2], dtype)
        _close_summed(got[2], want[2], dtype)
        _close_summed(got[3], want[3], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nb,rev_rows", [(6, (0, 1, 2, 3)), (3, (2, 0))])
def test_dirstream_adjoints_misaligned_views(gen, dtype, nb, rev_rows):
    """Inputs contiguous at an odd element offset of one buffer: K6 takes
    its scalar instance, K7 one value a thread."""
    L, d, b = 9, 8, 64
    nr = len(rev_rows)
    size = L * d * b
    flat = _randn(gen, (2 + 2 * (nb + nr)) * size + 1).to(dtype)
    at = [1]

    def take(n):                     # the next n planes of flat, as a view
        x = flat[at[0]:at[0] + n * size].view(n, L, d, b)
        at[0] += n * size
        return x

    u, g, gf, gr, yf, yr = (take(1)[0], take(1)[0], take(nb), take(nr),
                            take(nb), take(nr))
    # not aligned to a pair of values, nor to 16 bytes
    assert all(x.data_ptr() % (2 * x.element_size())
               for x in (u, g, gf, gr, yf, yr))
    orders, inv = _orders(L, nb, 5)
    rr = torch.tensor(rev_rows, dtype=torch.int32, device="cuda")
    cw, cb = 0.5 * _randn(gen, 4, d), 0.1 * _randn(gen, d)
    _check_conv_adjoint((u, cw, cb, orders, rr, gf, gr), dtype)
    w = torch.softmax(_randn(gen, nb + nr), 0)
    got = inv_perm_weighted_sum_backward(yf, yr, w[:nb], w[nb:], inv, rr, g)
    want = inv_perm_weighted_sum_backward_reference(yf, yr, w[:nb], w[nb:],
                                                    inv, rr, g)
    _close(got[:2], want[:2], dtype)
    _close_summed(got[2], want[2], dtype)
    _close_summed(got[3], want[3], dtype)


def _grads_through(fn, inputs, g):
    leaves = [x.detach().requires_grad_(x.is_floating_point())
              for x in inputs]
    out = fn(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    gs = g if isinstance(g, tuple) else (g,)
    assert all(o.grad_fn is not None for o in outs)
    torch.autograd.backward(outs, gs)
    return [x.grad for x in leaves if x.is_floating_point()]


def test_every_function_carries_gradients(gen):
    """The gradient of each kernel's autograd Function (forward K1-K4,
    backward K5-K7 or the plain attention formula) against autograd
    through its plain version: the fault where the kernels' outputs had no
    grad_fn and every parameter upstream got no gradient."""
    dtype = torch.float32
    args = _scan_args(gen, (2,), 13, 9, 16, 40, dtype)
    g = _randn(gen, 2, 13, 9, 40)
    for rev in (False, True):
        got = _grads_through(
            lambda *a: selective_scan(*a, reverse=rev), args, g)
        want = _grads_through(
            lambda *a: selective_scan_reference(*a, reverse=rev), args, g)
        for x, y in zip(got, want):
            _close_summed(x, y, dtype)

    orders, inv = _orders(11, 3, 5)
    rr = torch.tensor((0, 2), dtype=torch.int32, device="cuda")
    u = _randn(gen, 11, 6, 35)
    cw, cb = 0.5 * _randn(gen, 4, 6), 0.1 * _randn(gen, 6)
    gs = (_randn(gen, 3, 11, 6, 35), _randn(gen, 2, 11, 6, 35))
    conv = lambda *a: dir_conv_silu(*a, orders, rr)
    conv_ref = lambda *a: dir_conv_silu_reference(*a, orders, rr)
    for x, y in zip(_grads_through(conv, (u, cw, cb), gs),
                    _grads_through(conv_ref, (u, cw, cb), gs)):
        _close_summed(x, y, dtype)

    yf, yr = gs
    w = (torch.softmax(_randn(gen, 3), 0), torch.softmax(_randn(gen, 2), 0))
    g = _randn(gen, 11, 6, 35)
    isum = lambda *a: inv_perm_weighted_sum(*a, inv, rr)
    isum_ref = lambda *a: inv_perm_weighted_sum_reference(*a, inv, rr)
    for x, y in zip(_grads_through(isum, (yf, yr) + w, g),
                    _grads_through(isum_ref, (yf, yr) + w, g)):
        _close_summed(x, y, dtype)

    q, k, v = (0.5 * _randn(gen, 33, n, 24) for n in (7, 3, 3))
    g = _randn(gen, 33, 7, 24)
    att = lambda *a: fused_attention(*a, 0.7)
    att_ref = lambda *a: attention_reference(*a, 0.7)
    for x, y in zip(_grads_through(att, (q, k, v), g),
                    _grads_through(att_ref, (q, k, v), g)):
        _close(x, y, dtype)


def test_summed_gradients_are_bitwise_repeatable(gen):
    """dA, dD, dcw, dcb and dw come from per-block partials added in a
    fixed order (no atomics): two launches give the same bits."""
    dtype = torch.bfloat16
    args = _scan_args(gen, (6,), 81, 72, 16, 1001, dtype)
    g = _randn(gen, 6, 81, 72, 1001).to(dtype)
    first = selective_scan_backward(*args, g)
    second = selective_scan_backward(*args, g)
    for i in (2, 5):
        assert torch.equal(first[i], second[i])

    orders, inv = _orders(81, 6, 3)
    rr = torch.tensor((0, 1, 2, 3), dtype=torch.int32, device="cuda")
    u = _randn(gen, 81, 72, 1001).to(dtype)
    cw, cb = 0.5 * _randn(gen, 4, 72), 0.1 * _randn(gen, 72)
    gf = _randn(gen, 6, 81, 72, 1001).to(dtype)
    gr = _randn(gen, 4, 81, 72, 1001).to(dtype)
    first = dir_conv_silu_backward(u, cw, cb, orders, rr, gf, gr)
    second = dir_conv_silu_backward(u, cw, cb, orders, rr, gf, gr)
    assert torch.equal(first[1], second[1]) and torch.equal(first[2],
                                                            second[2])
    wf, wr = torch.softmax(_randn(gen, 6), 0), torch.softmax(_randn(gen, 4), 0)
    first = inv_perm_weighted_sum_backward(gf, gr, wf, wr, inv, rr, u)
    second = inv_perm_weighted_sum_backward(gf, gr, wf, wr, inv, rr, u)
    assert torch.equal(first[2], second[2]) and torch.equal(first[3],
                                                            second[3])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,n,h,hd,residual", [
    (1001, 65, 4, 16, True), (3, 146, 4, 16, False), (5, 1, 4, 16, True),
    (2, 512, 2, 32, True), (9, 33, 3, 12, False), (70000, 5, 16, 4, True),
    (7, 65, 4, 5, True), (11, 17, 4, 16, True), (6, 17, 16, 4, False),
    (2, 512, 8, 32, True), (4, 100, 3, 24, True)])
def test_heads_attention(gen, dtype, B, n, h, hd, residual):
    qkv = _randn(gen, B, n, 3 * h * hd).to(dtype)
    q, k, v = (t.view(B, n, h, hd) for t in qkv.chunk(3, dim=-1))
    before = _build.launches["fused_attention_heads"]
    got = fused_attention_heads(q, k, v, hd ** -0.5, residual)
    assert _build.launches["fused_attention_heads"] == before + 1
    _close(got, attention_reference_heads(q, k, v, hd ** -0.5, residual),
           dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,n,h,hd,residual", [
    (1001, 65, 16, 4, True), (3, 1, 16, 4, True), (4, 65, 5, 8, False),
    (2, 160, 4, 16, True), (2, 512, 1, 32, True), (5, 17, 16, 4, True),
    (7, 65, 4, 5, True), (3, 40, 2, 24, False)])
def test_pooled_heads_attention(gen, dtype, B, n, h, hd, residual):
    q, k, v = (_randn(gen, B, n, h * hd).to(dtype) for _ in range(3))
    lns = [((1 + 0.2 * _randn(gen, hd)).to(dtype),
            (0.1 * _randn(gen, hd)).to(dtype)) for _ in range(3)]
    flat = [p for ln in lns for p in ln]
    before = _build.launches["pooled_heads_attention"]
    got = pooled_heads_attention(q, k, v, *flat, h, hd ** -0.5, residual)
    assert _build.launches["pooled_heads_attention"] == before + 1
    # K9's LN statistics are float64: in float32 it is held to the plain
    # version in float64 (the float32 fast variance cancels)
    wide = (lambda x: x.double()) if dtype == torch.float32 else (
        lambda x: x)
    want = pooled_attention_reference(
        wide(q), wide(k), wide(v), *[tuple(map(wide, ln)) for ln in lns], h,
        hd ** -0.5, residual)
    _close(got, want.to(dtype), dtype)


@pytest.mark.parametrize("B,n,h,hd", [(3, 512, 8, 32), (2, 512, 64, 4)])
def test_pooled_bf16_takes_head_groups(gen, B, n, h, hd):
    """In bf16 K9 splits a batch row's heads over blocks where one block
    cannot stage them all (the float32 instance cannot, and raises)."""
    q, k, v = (_randn(gen, B, n, h * hd) for _ in range(3))
    lns = [p for _ in range(3) for p in (1 + 0.2 * _randn(gen, hd),
                                         0.1 * _randn(gen, hd))]
    with pytest.raises(ValueError, match="shared memory"):
        pooled_heads_attention(q, k, v, *lns, h, hd ** -0.5)
    q, k, v = (x.bfloat16() for x in (q, k, v))
    got = pooled_heads_attention(q, k, v, *lns, h, hd ** -0.5)
    want = pooled_attention_reference(q, k, v, *zip(lns[::2], lns[1::2]), h,
                                      hd ** -0.5)
    _close(got, want, torch.bfloat16)


@pytest.mark.parametrize("B,n,h,hd,residual", [
    (257, 65, 4, 16, True), (33, 146, 4, 16, False), (65, 65, 16, 4, True),
    (9, 17, 4, 5, True)])
def test_heads_bf16_kernel_against_float32_kernel(gen, B, n, h, hd,
                                                  residual):
    """K8's bf16 instance (tensor cores, P rounded to bf16) against its
    float32 instance on the same values cast up: within bf16's limit."""
    qkv = _randn(gen, B, n, 3 * h * hd).bfloat16()
    q, k, v = (t.view(B, n, h, hd) for t in qkv.chunk(3, dim=-1))
    got = fused_attention_heads(q, k, v, hd ** -0.5, residual)
    want = fused_attention_heads(q.float(), k.float(), v.float(), hd ** -0.5,
                                 residual)
    torch.testing.assert_close(got.float(), want, **TOL[torch.bfloat16])


def test_heads_functions_carry_gradients(gen):
    """K8's and K9's autograd Functions differentiate the plain formulas."""
    dtype = torch.float32
    q, k, v = (_randn(gen, 13, 65, 4, 16) for _ in range(3))
    g = _randn(gen, 13, 65, 4, 16)
    for res in (False, True):
        got = _grads_through(
            lambda *a: fused_attention_heads(*a, 0.25, res), (q, k, v), g)
        want = _grads_through(
            lambda *a: attention_reference_heads(*a, 0.25, res), (q, k, v), g)
        for x, y in zip(got, want):
            _close(x, y, dtype)
    qkv = tuple(_randn(gen, 7, 65, 64) for _ in range(3))
    lns = tuple(p for _ in range(3) for p in (1 + 0.2 * _randn(gen, 4),
                                              0.1 * _randn(gen, 4)))
    g = _randn(gen, 7, 65, 64)
    got = _grads_through(lambda *a: pooled_heads_attention(*a, 16, 0.5),
                         qkv + lns, g)
    want = _grads_through(
        lambda q, k, v, a, b, c, d, e, f: pooled_attention_reference(
            q, k, v, (a, b), (c, d), (e, f), 16, 0.5), qkv + lns, g)
    for x, y in zip(got, want):
        _close_summed(x, y, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [65, 145, 146])
def test_heads_attention_at_the_zoo_train_shapes(gen, dtype, n):
    """K8 under autograd at the zoo's train shapes (batch 1024, 4 heads of
    16; MHST and GLT_Net 65 tokens, S2EFT 145, SpectralFormer 146) on the
    strided q, k, v views of a fused qkv: the forward and the fused qkv's
    gradient against autograd through the plain version, one launch a
    forward and none in the backward."""
    B, h, hd = 1024, 4, 16
    qkv = _randn(gen, B, n, 3 * h * hd).to(dtype)
    g = _randn(gen, B, n, h, hd).to(dtype)

    def through(fn):
        x = qkv.detach().requires_grad_()
        out = fn(*(t.view(B, n, h, hd) for t in x.chunk(3, dim=-1)), 0.25)
        out.backward(g)
        return out.detach(), x.grad

    before = _build.launches["fused_attention_heads"]
    got = through(fused_attention_heads)
    assert _build.launches["fused_attention_heads"] == before + 1
    want = through(attention_reference_heads)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_pooled_attention_at_the_mhst_train_shape(gen, dtype):
    """K9 under autograd at MHST's train shape (batch 1024, 65 tokens, 16
    heads of 4): the forward against the plain version (float64 for
    float32, as above), the gradients of q, k, v and of the LN scales and
    biases (sums over every token and head) against autograd through the
    plain version; one launch a forward, none in the backward."""
    B, n, h, hd = 1024, 65, 16, 4
    qkv = tuple(_randn(gen, B, n, h * hd).to(dtype) for _ in range(3))
    lns = tuple((1 + 0.2 * _randn(gen, hd) if i % 2 == 0
                 else 0.1 * _randn(gen, hd)).to(dtype) for i in range(6))
    g = _randn(gen, B, n, h * hd).to(dtype)
    plain = lambda q, k, v, a, b, c, d, e, f: pooled_attention_reference(
        q, k, v, (a, b), (c, d), (e, f), h, 0.5)
    before = _build.launches["pooled_heads_attention"]
    got = _grads_through(lambda *a: pooled_heads_attention(*a, h, 0.5),
                         qkv + lns, g)
    assert _build.launches["pooled_heads_attention"] == before + 1
    want = _grads_through(plain, qkv + lns, g)
    for x, y in zip(got[:3], want[:3]):
        _close(x, y, dtype)
    for x, y in zip(got[3:], want[3:]):
        _close_summed(x, y, dtype)
    wide = (lambda x: x.double()) if dtype == torch.float32 else (
        lambda x: x)
    out = pooled_heads_attention(*qkv, *lns, h, 0.5)
    _close(out, plain(*map(wide, qkv + lns)).to(dtype), dtype)


def test_heads_wrappers_refuse_what_the_kernels_do_not_take(gen):
    q = _randn(gen, 2, 513, 4, 16)
    with pytest.raises(ValueError, match="n <= 512"):
        fused_attention_heads(q, q, q, 0.25)
    q = _randn(gen, 2, 9, 4, 16)
    with pytest.raises(ValueError, match="share their strides"):
        fused_attention_heads(q, q.contiguous().clone().transpose(0, 1)
                              .contiguous().transpose(0, 1), q, 0.25)
    with pytest.raises(ValueError, match="heads contiguous"):
        t = q.transpose(2, 3).contiguous().transpose(2, 3)
        fused_attention_heads(t, t, t, 0.25)
    # K9 in float32 stages all heads of a row in one block; in bf16 it
    # splits them into groups that fit (ops/attention.py _heads_group)
    x = _randn(gen, 2, 512, 256)
    ln = _randn(gen, 4)
    with pytest.raises(ValueError, match="shared memory"):
        pooled_heads_attention(x, x, x, *(ln,) * 6, 64, 0.5)
    x = x.bfloat16()
    assert pooled_heads_attention(x, x, x, *(ln,) * 6, 64, 0.5).shape == \
        x.shape


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("lead,L,d,n,b,reverse", [
    ((6,), 81, 72, 16, 1001, False), ((4,), 49, 128, 16, 33, True),
    ((), 13, 9, 4, 70, False), ((2,), 30, 5, 16, 1, True)])
def test_every_tiled_scan_instance(gen, dtype, lead, L, d, n, b, reverse):
    """Each (rows, chunk) instance of V1 against the plain scan; the
    instance at K1's plan is K1's kernel, so equal to K1 bit for bit."""
    args = _scan_args(gen, lead, L, d, n, b, dtype)
    want = selective_scan_reference(*args, reverse)
    k1 = selective_scan(*args, reverse=reverse)
    plan = k1_instance(lead[0] if lead else 1, L, d, n, b, dtype)
    for rows in TILE_ROWS:
        for chunk in TILE_CHUNKS:
            before = _build.launches["selective_scan_tiled"]
            got = selective_scan_tiled(*args, reverse=reverse, rows=rows,
                                       chunk=chunk)
            assert _build.launches["selective_scan_tiled"] == before + 1
            _close(got, want, dtype)
            if (rows, chunk) == plan:
                assert torch.equal(got, k1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,L,d,n", [
    (1001, 81, 72, 16), (333, 49, 128, 16), (7, 20, 300, 4), (5, 3, 1, 16)])
def test_batch_major_scan(gen, dtype, b, L, d, n):
    u, dt, A, B, C, D = _scan_args(gen, (), L, d, n, b, dtype)
    bm = [x.permute(2, 0, 1).contiguous() for x in (u, dt, B, C)]
    before = _build.launches["selective_scan_batch_major"]
    got = selective_scan_batch_major(bm[0], bm[1], A, bm[2], bm[3], D)
    assert _build.launches["selective_scan_batch_major"] == before + 1
    _close(got, selective_scan_batch_major_reference(
        bm[0], bm[1], A, bm[2], bm[3], D), dtype)


@pytest.mark.parametrize("B,n,h,hd", [
    (1001, 65, 16, 4), (3, 146, 4, 16), (1001, 1, 4, 16), (7, 1, 16, 4),
    (33, 65, 4, 16), (5, 146, 16, 4), (9, 17, 3, 6)])
def test_heads_attention_variants(gen, B, n, h, hd):
    """V4 in float32 and bf16, V3 (bf16 only, per head and, where h * hd
    is a multiple of 16 up to 128, head-masked) against the plain version.
    V3 rounds P to bf16 before P.V: bf16's tolerance covers it."""
    for dtype in DTYPES:
        q, k, v = (_randn(gen, B, n, h, hd).to(dtype) for _ in range(3))
        want = attention_reference_heads(q, k, v, hd ** -0.5)
        before = _build.launches["heads_attention_outer"]
        _close(heads_attention_outer(q, k, v, hd ** -0.5), want, dtype)
        assert _build.launches["heads_attention_outer"] == before + 1
        if dtype != torch.bfloat16:
            continue
        masks = (False, True) if (h * hd) % 16 == 0 and h * hd <= 128 \
            else (False,)
        for masked in masks:
            before = _build.launches["heads_attention_mma"]
            _close(heads_attention_mma(q, k, v, hd ** -0.5, masked), want,
                   dtype)
            assert _build.launches["heads_attention_mma"] == before + 1


def _offset(x):
    """x's values in a contiguous view one value past an aligned
    address."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = flat[1:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,L,d,n,offset", [
    (8, 81, 72, 16, False),       # 7 sequences a block: a ragged last block
    (33, 13, 9, 16, False),       # odd d, L past one 8-step chunk
    (6, 3, 1, 5, False),          # d = 1, L shorter than one chunk
    (3, 20, 1024, 16, False),     # d = 1024: one sequence a block
    (17, 40, 128, 7, False),      # n < 16: value-by-value staging
    (9, 81, 72, 16, True),        # offset views: no pairs, no cp.async
    (9, 49, 128, 1, True)])
def test_batch_major_scan_edges(gen, dtype, b, L, d, n, offset):
    """V2 at the edges of its design: the batch edge inside a block, d odd,
    1 and 1,024, n below 16, L below and past the staging chunk, and
    u, dt, B, C one value past an aligned address."""
    u, dt, A, B, C, D = _scan_args(gen, (), L, d, n, b, dtype)
    u, dt, B, C = [x.permute(2, 0, 1).contiguous() for x in (u, dt, B, C)]
    if offset:
        u, dt, B, C = map(_offset, (u, dt, B, C))
    before = _build.launches["selective_scan_batch_major"]
    got = selective_scan_batch_major(u, dt, A, B, C, D)
    assert _build.launches["selective_scan_batch_major"] == before + 1
    _close(got, selective_scan_batch_major_reference(u, dt, A, B, C, D),
           dtype)


def _mma_max_n(c):
    """The largest n whose batch row V3 stages in one block."""
    return max(n for n in range(1, MAX_N + 1)
               if mma_smem(n, c) <= SMEM_LIMIT)


@pytest.mark.parametrize("h,hd", [(16, 2), (16, 4), (8, 6), (4, 16),
                                  (16, 16)])
@pytest.mark.parametrize("n", [1, 17, 65, 146, 160, 161, "max"])
def test_heads_attention_mma_edges(gen, h, hd, n):
    """V3 per head and, where h * hd is a multiple of 16 up to 128, head-
    masked, at one token, a last key tile of one real key (17), the zoo's
    65 and 146, the wgmma form's last n (160) and the first past it
    (161), and the largest n the shared memory takes; head widths 2, 4
    (mma_k8), 6 (windows that straddle 8 channels) and 16 (wgmma at 4
    heads up to 160 tokens); C = 256 per head. Batches past the resident
    blocks run the two-stage ring."""
    c = h * hd
    tokens = _mma_max_n(c) if n == "max" else min(n, _mma_max_n(c))
    B = 1001 if tokens <= 65 else 33 if tokens <= 161 else 3
    q, k, v = (_randn(gen, B, tokens, h, hd).bfloat16() for _ in range(3))
    want = attention_reference_heads(q, k, v, hd ** -0.5)
    masks = (False, True) if c % 16 == 0 and c <= 128 else (False,)
    for masked in masks:
        before = _build.launches["heads_attention_mma"]
        _close(heads_attention_mma(q, k, v, hd ** -0.5, masked), want,
               torch.bfloat16)
        assert _build.launches["heads_attention_mma"] == before + 1


@pytest.mark.parametrize("B,n,h,hd", [(7, 65, 16, 4), (7, 146, 4, 16),
                                      (5, 17, 3, 6)])
def test_heads_attention_mma_offset_views(gen, B, n, h, hd):
    """q, k, v one value past an aligned address: the value-by-value
    staging (no TMA row copies, no cp.async, no wgmma), per head and
    masked."""
    q, k, v = (_offset(_randn(gen, B, n, h, hd).bfloat16())
               for _ in range(3))
    want = attention_reference_heads(q, k, v, 0.5)
    masks = (False, True) if (h * hd) % 16 == 0 else (False,)
    for masked in masks:
        _close(heads_attention_mma(q, k, v, 0.5, masked), want,
               torch.bfloat16)


@pytest.mark.parametrize("B,n,h,hd", [
    (7, 65, 16, 4), (5, 146, 16, 4), (7, 65, 8, 2), (5, 17, 3, 6),
    (33, 65, 4, 16), (3, 146, 4, 16)])
def test_heads_attention_mma_keeps_each_head_apart(gen, B, n, h, hd):
    """An inf in head 1's K and V and a NaN in its q reach no other head,
    as the per-head plain version never reads them: the heads that share
    head 1's 8-channel windows (hd 2, 4, 6), the online softmax (n = 146),
    the wgmma form (hd = 16) and the masked form, whose one accumulator
    holds every head's columns."""
    q, k, v = (_randn(gen, B, n, h, hd).bfloat16() for _ in range(3))
    k[:, 3, 1, 0] = float("inf")
    v[:, 4, 1, hd - 1] = float("inf")
    q[:, 5, 1, hd - 1] = float("nan")
    want = attention_reference_heads(q, k, v, hd ** -0.5)
    others = [i for i in range(h) if i != 1]
    masks = (False, True) if (h * hd) % 16 == 0 else (False,)
    for masked in masks:
        got = heads_attention_mma(q, k, v, hd ** -0.5, masked)
        assert torch.isfinite(got[:, :, others]).all()
        _close(got[:, :, others], want[:, :, others], torch.bfloat16)


def _outer_max_n(c):
    """The largest n whose K and V V4 stages in one block."""
    return max(n for n in range(1, MAX_N + 1)
               if outer_smem(n, c) <= SMEM_LIMIT)


@pytest.mark.parametrize("hd", [1, 3, 4, 5, 16, 17, 32])
@pytest.mark.parametrize("n", [1, 65, 146, "max"])
def test_heads_attention_outer_domain(gen, hd, n):
    """V4 across head widths (h = min(16, 256 // hd) heads: C up to 256)
    and token counts up to the largest its shared memory takes, at a
    ragged batch, in both dtypes."""
    h = min(16, 256 // hd)
    for dtype in DTYPES:
        tokens = min(MAX_N if n == "max" else n, _outer_max_n(h * hd))
        B = 5 if tokens > 146 else 33
        q, k, v = (_randn(gen, B, tokens, h, hd).to(dtype) for _ in range(3))
        before = _build.launches["heads_attention_outer"]
        _close(heads_attention_outer(q, k, v, hd ** -0.5),
               attention_reference_heads(q, k, v, hd ** -0.5), dtype)
        assert _build.launches["heads_attention_outer"] == before + 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_heads_attention_outer_offset_views(gen, dtype):
    """q, k, v and o one value past an aligned address (contiguous views
    with an offset): the scalar q / o loads and value-wise staging."""
    B, n, h, hd = 7, 65, 16, 4

    def shifted():
        flat = _randn(gen, B * n * h * hd + 1).to(dtype)
        return flat[1:].view(B, n, h, hd)

    q, k, v = shifted(), shifted(), shifted()
    _close(heads_attention_outer(q, k, v, 0.5),
           attention_reference_heads(q, k, v, 0.5), dtype)


def test_variant_wrappers_refuse_what_the_kernels_do_not_take(gen):
    q = _randn(gen, 2, 9, 4, 16)
    with pytest.raises(TypeError, match="bfloat16"):
        heads_attention_mma(q, q, q, 0.25)
    with pytest.raises(ValueError, match="contiguous"):
        t = q.transpose(1, 2).contiguous().transpose(1, 2)
        heads_attention_outer(t, t, t, 0.25)
    with pytest.raises(ValueError, match="forward only"):
        heads_attention_outer(q.requires_grad_(), q, q, 0.25)


# --------------------------------------------------------------------------
# the shuffle paths' stream counts, and the Mamba layers on the card
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("nb,nr", [(1, 0), (2, 1), (3, 1)])
def test_dirstream_with_a_fresh_order_row(gen, dtype, nb, nr):
    """K2, K3 and their adjoints K6, K7 at the stream counts of the shuffle
    paths: nb - 1 static rows, then a row drawn anew on every call (as
    MultiDirMambaLayer appends its shuffle permutation), so a table kept
    from an earlier launch would show."""
    L, d, b = 81, 72, 333
    static, static_inv = _orders(L, nb, 7)
    rr = torch.arange(nr, dtype=torch.int32, device="cuda")
    for _ in range(3):
        p = torch.randperm(L, generator=gen, device="cuda")
        orders = torch.cat([static[:nb - 1], p.to(torch.int32)[None]])
        inv = torch.cat([static_inv[:nb - 1],
                         torch.argsort(p).to(torch.int32)[None]])
        u = _randn(gen, L, d, b).to(dtype)
        cw, cb = 0.5 * _randn(gen, 4, d), 0.1 * _randn(gen, d)
        got = dir_conv_silu(u, cw, cb, orders, rr)
        _close(got, dir_conv_silu_reference(u, cw, cb, orders, rr), dtype)
        yf, yr = got
        w = torch.softmax(_randn(gen, nb + nr), 0)
        wf, wr = w[:nb], w[nb:]
        _close(inv_perm_weighted_sum(yf, yr, wf, wr, inv, rr),
               inv_perm_weighted_sum_reference(yf, yr, wf, wr, inv, rr),
               dtype)
        gf, gr = (_randn(gen, n, L, d, b).to(dtype) for n in (nb, nr))
        du, dcw, dcb = dir_conv_silu_backward(u, cw, cb, orders, rr, gf, gr)
        want = dir_conv_silu_backward_reference(u, cw, cb, orders, rr, gf,
                                                gr)
        _close(du, want[0], dtype)
        _close_summed(dcw, want[1], dtype)
        _close_summed(dcb, want[2], dtype)
        cot = _randn(gen, L, d, b).to(dtype)
        got = inv_perm_weighted_sum_backward(yf, yr, wf, wr, inv, rr, cot)
        want = inv_perm_weighted_sum_backward_reference(yf, yr, wf, wr, inv,
                                                        rr, cot)
        _close(got[:2], want[:2], dtype)
        for x, y in zip(got[2:], want[2:]):
            _close_summed(x, y, dtype)


def _layer_on_both(net, x, draws):
    """float32 forward + backward of ``net`` on the CPU, then on the card
    with the CPU's draws replayed: (outputs, gradients) of each."""
    from vit_cnn_tpu_torch.nn import noise

    rec = noise.Recorder(torch.Generator().manual_seed(0))
    res = []
    for device in ("cpu", "cuda"):
        net.to(device).zero_grad(set_to_none=True)
        xt = x.to(device).detach().requires_grad_(True)
        with noise.drawing(rec if device == "cpu"
                           else noise.Replay(rec.draws)):
            out = net(xt)
        out.backward(torch.ones_like(out))
        # copies: moving the module to the card moves its grads too
        res.append((out.detach().cpu(), [xt.grad.to("cpu", copy=True)] + [
            p.grad.to("cpu", copy=True) for p in net.parameters()]))
    draws.extend(rec.draws)
    return res


def _grads_match(got, want):
    for g, w in zip(got, want):
        scale = float(w.norm())
        assert float((g - w).norm()) <= 1e-3 * scale + 1e-6, (
            float((g - w).norm()), scale)


@pytest.mark.parametrize("path", [
    "forward", "shuffle", "eight_directions_gate", "9twoclock", "81_2+8",
    "forward_reverse_mean", "forward_reverse_gate",
    "forward_reverse_shuffle_gate", "forward_reverse_shuffle_mean"])
def test_every_path_type_on_the_card(gen, path):
    """MultiDirMambaLayer of every path kind on the card against the CPU at
    a ragged batch, the shuffle rows replayed, with the kernels' launches:
    K1 forward (and reverse), K2 once, K3 unless the per-sample gate
    restores the directions apart; the same adjoints."""
    from vit_cnn_tpu_torch.convert import seeded_state_dict
    from vit_cnn_tpu_torch.nn.mamba import MultiDirMambaLayer

    layer = MultiDirMambaLayer(32, 16, path, 81)
    layer.load_state_dict(seeded_state_dict(layer, 1))
    x = torch.randn((37, 81, 32), generator=torch.Generator().manual_seed(2))
    _build.launches.clear()
    draws = []
    (want, g_want), (got, g_got) = _layer_on_both(layer, x, draws)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    _grads_match(g_got, g_want)
    assert len(draws) == (path.count("shuffle"))
    nr = int(layer.rev_rows.numel() > 0)
    k3 = int(layer.combine != "dynamic")
    for name, n in (("selective_scan", 1 + nr), ("dir_conv_silu", 1),
                    ("inv_perm_weighted_sum", k3)):
        assert _build.launches[name] == n, name
        assert _build.launches[name + "_backward"] == n, name


@pytest.mark.parametrize("b", [1, 33, 1001])
def test_mamba_mixer_on_the_card(gen, b):
    """The batch-major MambaMixer (K2 with the identity order, K1 on one
    stream) against the CPU at batches that are no multiple of K1's
    tile."""
    from vit_cnn_tpu_torch.convert import seeded_state_dict
    from vit_cnn_tpu_torch.nn import MambaMixer

    mixer = MambaMixer(32, 16)
    mixer.load_state_dict(seeded_state_dict(mixer, 3))
    x = torch.randn((b, 81, 32), generator=torch.Generator().manual_seed(b))
    _build.launches.clear()
    (want, g_want), (got, g_got) = _layer_on_both(mixer, x, [])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    _grads_match(g_got, g_want)
    assert _build.launches["selective_scan"] == 1
    assert _build.launches["dir_conv_silu"] == 1


def test_two_ranks_sharing_the_card_match_one(gen):
    """The mesh's shared-card backend: two gloo ranks on this card (this
    process rank 0, vit_cnn_tpu_torch.parallel.mesh) against world size 1
    on the card, on a random 20 x 24 scene of 20 + 1 bands: two flagship
    train steps with flip at batch 16 (step-1 loss within 1e-5 + 1e-4
    |L|, both within rtol 5e-3 / atol 1e-4, the ranks' parameters equal,
    the adjoints launched on each rank once per step and use site) and
    the band map (within 1e-5 of max(1, max|map|))."""
    from vit_cnn_tpu_torch.convert import seeded_state_dict
    from vit_cnn_tpu_torch.models.registry import get_model
    from vit_cnn_tpu_torch.parallel import make_mesh
    from vit_cnn_tpu_torch.tools import mesh_check as mc

    rng = np.random.RandomState(0)
    scene = (rng.rand(20, 24, 20).astype(np.float32),
             rng.rand(20, 24, 1).astype(np.float32),
             rng.randint(0, 5, (20, 24)))
    hp = dict(dataset="Synthetic", n_classes=5, n_bands=(20, 1),
              ignored_labels=[0], batch_size=16, epoch=1,
              flip_augmentation=True)
    case = dict(model="Multimodality_Mamba", scene=scene, hp=hp,
                state=seeded_state_dict(get_model(
                    "Multimodality_Mamba", **hp)[0], 0),
                dtype="float32", device="cuda", seed=1)
    one = mc.train_steps(None, case, 2)
    one_map = mc.maps(None, case, (1,), chunk=32)[1]
    with make_mesh(2, "cuda", share=True) as mesh:
        assert mesh.backend == "gloo"
        two = mesh.run(mc.train_steps, case, 2)
        two_map = mesh.run(mc.maps, case, (1,), chunk=32)[1]
    l1, l2 = one["losses"], two["losses"]
    assert abs(l2[0] - l1[0]) <= 1e-5 + 1e-4 * abs(l1[0])
    np.testing.assert_allclose(l2, l1, rtol=5e-3, atol=1e-4)
    assert two["spread"] == 0.0
    for counts in two["launches"]:
        assert counts["selective_scan_backward"] == 4 * 2
        assert counts["inv_perm_weighted_sum_backward"] == 2 * 2
    assert np.abs(one_map).sum() > 0
    np.testing.assert_allclose(two_map, one_map, rtol=0, atol=1e-5 * max(
        1.0, float(np.abs(one_map).max())))
