"""The plain versions behind kernels K8 and K9 (the CPU path of
vit_cnn_tpu_torch.ops.attention) against the JAX package: its
``attention_reference_heads``, ``ln_groups_reference`` and
``pooled_attention_reference``, and its Pallas kernels
``fused_attention_heads`` and ``pooled_heads_attention`` in interpret mode,
at the zoo's shapes: 4 heads of 16 over 65 (MHST, GLT_Net), 145 (S2EFT)
and 146 (SpectralFormer) tokens, and MHST's pooled tail, 16 heads of 4
over 65 tokens. Small batches; the Pallas block is chosen so the batch
needs padding.

Tolerance: the JAX suite's float32 op tolerance, rtol 2e-4 / atol 2e-5.
In bf16 the Pallas kernels round the normalised P to bf16 before P.V
(vit_cnn_tpu/ops/attention.py:131, :352) where the plain version keeps
it in float32: the two are held to the bf16 limit that the card's kernels
are held to against the plain version (``tools.TOL``, rtol 2e-2 / atol
2e-2), which so covers the TPU kernels' own bf16 P.

The planner of the kernels' blocks (``_heads_group``) is held to the
shape domain of the float32 layout, which both dtypes once used: every
shape it took gets a group of heads whose staging fits in one block's
shared memory, in either dtype.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_cnn_tpu.ops import attention as jax_attention
from vit_cnn_tpu_torch.ops import attention
from vit_cnn_tpu_torch.tools import TOL

RTOL, ATOL = 2e-4, 2e-5
BF16_RTOL, BF16_ATOL = TOL["bfloat16"]
HEAD_SHAPES = [(65, 4, 16), (145, 4, 16), (146, 4, 16)]


def _heads(b, n, h, hd, seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, n, h, hd).astype(np.float32) for _ in range(3))


def _pooled(b, n, h, hd, seed):
    rng = np.random.RandomState(seed)
    qkv = tuple((1.5 * rng.randn(b, n, h * hd) + 0.3).astype(np.float32)
                for _ in range(3))
    lns = tuple(((1.0 + 0.2 * rng.randn(hd)).astype(np.float32),
                 (0.1 * rng.randn(hd)).astype(np.float32)) for _ in range(3))
    return qkv, lns


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("n,h,hd", HEAD_SHAPES)
def test_heads_plain_matches_jax_reference(n, h, hd, residual):
    q, k, v = _heads(3, n, h, hd, n)
    want = jax_attention.attention_reference_heads(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), hd ** -0.5, residual)
    got = attention.fused_attention_heads(*_t(q, k, v), hd ** -0.5, residual)
    assert got.shape == (3, n, h, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("n", [65, 146])
def test_heads_plain_matches_pallas_kernel_interpret(n, residual):
    """The Pallas kernel itself, batch 5 in blocks of 4."""
    from jax.experimental.pallas import tpu as pltpu

    q, k, v = _heads(5, n, 4, 16, 2 * n)
    with pltpu.force_tpu_interpret_mode():
        want = jax_attention.fused_attention_heads(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.25, 4, residual)
    got = attention.fused_attention_heads_auto(*_t(q, k, v), 0.25, residual)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_heads_take_strided_qkv_views():
    """ViTAttention hands K8 the three column blocks of one fused qkv
    projection as (B, n, h, hd) views; the result is that of contiguous
    copies."""
    b, n, h, hd = 2, 65, 4, 16
    qkv = torch.from_numpy(np.random.RandomState(1).randn(
        b, n, 3 * h * hd).astype(np.float32))
    views = [t.view(b, n, h, hd) for t in qkv.chunk(3, dim=-1)]
    assert not views[0].is_contiguous()
    got = attention.fused_attention_heads(*views, 0.25, True)
    want = attention.fused_attention_heads(
        *(t.contiguous() for t in views), 0.25, True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_ln_groups_plain_matches_jax():
    (x, _, _), ((g, b), _, _) = _pooled(3, 65, 16, 4, 3)
    x[0, 0, :4] = 0.25                      # a group of zero variance
    want = jax_attention.ln_groups_reference(jnp.asarray(x), jnp.asarray(g),
                                             jnp.asarray(b), 4)
    got = attention.ln_groups_reference(*_t(x, g, b), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("residual", [True, False])
def test_pooled_plain_matches_jax_reference(residual):
    (q, k, v), lns = _pooled(3, 65, 16, 4, 4)
    want = jax_attention.pooled_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        *[tuple(map(jnp.asarray, ln)) for ln in lns], 16, 0.5, residual)
    got = attention.pooled_heads_attention_auto(
        *_t(q, k, v), *[_t(*ln) for ln in lns], 16, 0.5, residual)
    assert got.shape == (3, 65, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("residual", [True, False])
def test_pooled_plain_matches_pallas_kernel_interpret(residual):
    """The Pallas kernel that the TPU gates off, batch 5 in blocks of 4."""
    from jax.experimental.pallas import tpu as pltpu

    (q, k, v), lns = _pooled(5, 65, 16, 4, 5)
    flat = [p for ln in lns for p in ln]
    with pltpu.force_tpu_interpret_mode():
        want = jax_attention.pooled_heads_attention(
            *map(jnp.asarray, [q, k, v] + flat), 16, 0.5, 4, residual)
    got = attention.pooled_heads_attention(*_t(q, k, v, *flat), 16, 0.5,
                                           residual)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_pooled_plain_gradients_match_jax():
    """The backward of K9's Function differentiates the plain composition:
    its gradients for q, k, v and the six LN vectors are JAX's."""
    (q, k, v), lns = _pooled(2, 17, 4, 4, 6)
    cot = np.random.RandomState(7).randn(2, 17, 16).astype(np.float32)
    flat = [q, k, v] + [p for ln in lns for p in ln]

    def jax_fn(q, k, v, gq, bq, gk, bk, gv, bv):
        return jax_attention.pooled_attention_reference(
            q, k, v, (gq, bq), (gk, bk), (gv, bv), 4, 0.5, True)

    _, vjp = jax.vjp(jax_fn, *map(jnp.asarray, flat))
    want = vjp(jnp.asarray(cot))
    leaves = [torch.from_numpy(a).requires_grad_() for a in flat]
    out = attention.pooled_heads_attention(*leaves, 4, 0.5, True)
    out.backward(torch.from_numpy(cot))
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n,h,hd,heads_per_block", [
    (513, 4, 16, 1), (65, 4, 33, 1), (65, 32, 16, 1), (512, 64, 4, 64)])
def test_kernel_shape_limits_raise(n, h, hd, heads_per_block):
    """K8 takes n <= 512, hd <= 32, h * hd <= 256; K9 (all heads in one
    block) also needs its q, k, v rows to fit in shared memory."""
    with pytest.raises(ValueError):
        attention._check_heads_shape(n, h, hd, heads_per_block)
    attention._check_heads_shape(146, 4, 16, 1)
    attention._check_heads_shape(65, 16, 4, 16)


def _bf16(*arrays):
    """The same bf16 values for both sides: jax and torch both round
    float32 to the nearest even bf16."""
    return (tuple(jnp.asarray(a).astype(jnp.bfloat16) for a in arrays),
            tuple(torch.from_numpy(a).bfloat16() for a in arrays))


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("n", [65, 146])
def test_heads_plain_bf16_within_the_card_limit_of_pallas(n, residual):
    """bf16, 4 heads of 16: the Pallas kernel (bf16 P) against the port's
    plain version (float32 P), batch 5 in blocks of 4."""
    from jax.experimental.pallas import tpu as pltpu

    (jq, jk, jv), tqkv = _bf16(*_heads(5, n, 4, 16, 3 * n))
    with pltpu.force_tpu_interpret_mode():
        want = jax_attention.fused_attention_heads(jq, jk, jv, 0.25, 4,
                                                   residual)
    got = attention.fused_attention_heads(*tqkv, 0.25, residual)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=BF16_RTOL, atol=BF16_ATOL)


@pytest.mark.parametrize("n", [65, 146])
def test_pooled_plain_bf16_within_the_card_limit_of_pallas(n):
    """bf16, 16 heads of 4, the LN scales and biases in float32: the
    Pallas pooled kernel against the port's plain version."""
    from jax.experimental.pallas import tpu as pltpu

    (q, k, v), lns = _pooled(5, n, 16, 4, n + 1)
    flat = [p for ln in lns for p in ln]
    (jq, jk, jv), tqkv = _bf16(q, k, v)
    with pltpu.force_tpu_interpret_mode():
        want = jax_attention.pooled_heads_attention(
            jq, jk, jv, *map(jnp.asarray, flat), 16, 0.5, 4, True)
    got = attention.pooled_heads_attention(*tqkv, *_t(*flat), 16, 0.5, True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=BF16_RTOL, atol=BF16_ATOL)


def _float32_layout_took(n, h, hd, pooled):
    """The shapes K8 (one head per block) and K9 (all heads) took when both
    dtypes staged q, k and v as float32 rows: the limits and that staging
    in shared memory."""
    heads = h if pooled else 1
    return (1 <= n <= 512 and 1 <= hd <= 32 and 1 <= h * hd <= 256
            and 4 * (3 * heads * n * (hd | 1) + 8 * n) <= 232448)


@pytest.mark.parametrize("pooled", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_heads_planner_keeps_the_domain(dtype, pooled):
    """Every shape the float32 layout took gets a head group >= 1 that
    fits."""
    taken = 0
    for n in (1, 2, 15, 16, 17, 33, 64, 65, 100, 145, 146, 256, 257, 511,
              512):
        for hd in range(1, 33):
            for h in sorted({1, 2, 3, 4, 5, 7, 8, 16, 64, 256 // hd}):
                if not _float32_layout_took(n, h, hd, pooled):
                    continue
                group = attention._heads_group(n, h, hd, dtype, pooled)
                assert 1 <= group <= h
                assert (attention._heads_smem(n, group, hd, dtype)
                        <= attention.SMEM_LIMIT)
                taken += 1
    assert taken > 1000


def test_float32_pooled_states_its_shared_memory_limit():
    """float32 K9 stages all 16 heads of 4 in one block: it takes n = 234
    and refuses n = 235 with the bytes it would need (bf16 splits the
    heads instead)."""
    assert attention._heads_group(234, 16, 4, torch.float32, True) == 16
    with pytest.raises(ValueError, match="233120 bytes of shared memory "
                       "per block, over the card's 232448"):
        attention._heads_group(235, 16, 4, torch.float32, True)
    assert attention._heads_group(235, 16, 4, torch.bfloat16, True) == 16


@pytest.mark.parametrize("n,h,hd,pooled,group", [
    (65, 4, 16, False, 4), (145, 4, 16, False, 4), (146, 4, 16, False, 4),
    (65, 16, 4, True, 16), (512, 8, 32, False, 2), (512, 64, 4, True, 8)])
def test_bf16_blocks_take_every_zoo_head(n, h, hd, pooled, group):
    """bf16 blocks stage every head of a batch row at the zoo's shapes;
    at n = 512 they split the heads evenly (K9 too, where its float32
    instance cannot take the shape)."""
    assert attention._heads_group(n, h, hd, torch.bfloat16, pooled) == group
    if pooled and group < h:
        with pytest.raises(ValueError, match="shared memory"):
            attention._heads_group(n, h, hd, torch.float32, pooled)
