"""Radiation and mixture augmentation in the port against the JAX
package, on the CPU.

* The noises' formulas on JAX's own draws: the JAX ``make_batch`` runs
  with a key, the test rebuilds every draw from that key by the same
  splits (the flip/rotate codes, the gates, the weights, the mixture's
  picks, the normal noise) in one jitted program, as float32, and hands
  them to the port's ``make_batch`` as explicit ``codes`` and ``draws``.
  float32 scenes: rtol 1e-5 / atol 1e-6 (another rounding of the same
  float32 formula). bf16 scenes: both sides compute the noised patch in
  float32 from the same bf16 values (JAX's float32 weights promote it);
  JAX draws the normal in bf16, and XLA computes it fused into that
  float32 sum with float32 precision in places and bf16 in others (the
  rebuilt draw is not bit for bit the fused one), so the noise term adds
  one bf16 rounding of the draw to the atol: beta * 2^-8 * max|noise|.
  Labels and the LiDAR exactly.
* The port's own draws (a CPU generator): the gate rates within 4
  standard deviations of 0.1 and 0.2, alpha in [0.9, 1.1) and the
  mixture's weights in [0.01, 1), unit-variance noise, and the noise
  applied to about 10% of the samples, as tests/test_pipeline.py holds
  the JAX package's.
* ``--radiation_augmentation --mixture_augmentation`` through the CLI.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_cnn_tpu.pipeline import patches as jax_patches
from vit_cnn_tpu_torch import cli
from vit_cnn_tpu_torch.pipeline import patches

RTOL, ATOL = 1e-5, 1e-6
P, BANDS, K = 5, 6, 6
BATCH = 64


def _scene(seed=0, h=18, w=20):
    """Labels 0..4 (0 ignored) everywhere but row 1, class 5: outside the
    interior rows, so class 5 shows in patches with a count of 0."""
    rng = np.random.RandomState(seed)
    img1 = rng.rand(h, w, BANDS).astype(np.float32)
    img2 = rng.rand(h, w, 1).astype(np.float32)
    gt = rng.randint(0, K - 1, (h, w)).astype(np.int64)
    gt[1] = K - 1
    return img1, img2, gt


def _jax_draws(key, cfg, b, shape, dtype, fold=True):
    """The codes and noise draws of JAX ``make_batch(key, ...)``, rebuilt
    by its key splits (pipeline/patches.py make_batch, augment_batch,
    radiation_noise, mixture_noise); jit this, as make_batch runs.
    ``fold=False``: the flip codes of ``TwoViewPipeline.make_views``, from
    the first of each sample's five keys."""
    codes = None
    if cfg.flip and fold:
        k_geo, key = jax.random.split(key)
        codes = jax.vmap(jax_patches.sample_geom_code)(
            jax.random.split(k_geo, b))
    keys = jax.vmap(lambda k: jax.random.split(k, 5))(
        jax.random.split(key, b))
    if cfg.flip and not fold:
        codes = jax.vmap(jax_patches.sample_geom_code)(keys[:, 0])
    draws = {}
    mix_dtype = dtype
    if cfg.radiation:
        k_a, k_n = jnp.moveaxis(jax.vmap(jax.random.split)(keys[:, 2]), 1, 0)
        draws.update(
            radiation_gate=jax.vmap(jax.random.uniform)(keys[:, 1]),
            radiation_alpha=jax.vmap(lambda k: jax.random.uniform(
                k, (), minval=0.9, maxval=1.1))(k_a),
            radiation_noise=jax.vmap(lambda k: jax.random.normal(
                k, shape, dtype=dtype))(k_n))
        mix_dtype = jnp.float32        # the gated where promotes the patch
    if cfg.mixture:
        k_a, k_pick, k_n = jnp.moveaxis(jax.vmap(
            lambda k: jax.random.split(k, 3))(keys[:, 4]), 1, 0)
        draws.update(
            mixture_gate=jax.vmap(jax.random.uniform)(keys[:, 3]),
            mixture_alpha=jax.vmap(lambda k: jax.random.uniform(
                k, (2,), minval=0.01, maxval=1.0))(k_a),
            mixture_pick=jax.vmap(lambda k: jax.random.uniform(
                k, (shape[0] * shape[1],)).reshape(shape[:2]))(k_pick),
            mixture_noise=jax.vmap(lambda k: jax.random.normal(
                k, shape, dtype=mix_dtype))(k_n))
    return codes, {k: v.astype(jnp.float32) for k, v in draws.items()}


@pytest.mark.parametrize("flip,radiation,mixture,bf16", [
    (True, True, True, False), (True, True, True, True),
    (False, False, True, True), (False, True, False, False)])
def test_noises_match_jax_on_its_draws(flip, radiation, mixture, bf16):
    img1, img2, gt = _scene()
    cfg_j = jax_patches.AugmentConfig(flip=flip, radiation=radiation,
                                      mixture=mixture)
    cfg_t = patches.AugmentConfig(flip=flip, radiation=radiation,
                                  mixture=mixture)
    jp = jax_patches.PatchPipeline(img1, img2, gt, P, [0], K, augment=cfg_j)
    tp = patches.PatchPipeline(img1, img2, gt, P, [0], K, augment=cfg_t)
    if bf16:
        jp.to_compute_dtype(jnp.bfloat16)
        tp.to_compute_dtype(torch.bfloat16)
    np.testing.assert_array_equal(tp.indices, jp.indices)
    if mixture:
        np.testing.assert_array_equal(tp.class_table.numpy(),
                                      np.asarray(jp.class_table))
        np.testing.assert_array_equal(tp.class_counts.numpy(),
                                      np.asarray(jp.class_counts))
        assert tp.class_counts[K - 1] == 0
    centers = np.random.RandomState(1).permutation(jp.indices)[:BATCH]
    key = jax.random.PRNGKey(3)
    want = jax.jit(lambda k, c: jp.make_batch(k, c, train=True))(
        key, jnp.asarray(centers))
    codes, draws = jax.jit(lambda k: _jax_draws(
        k, cfg_j, BATCH, (P, P, BANDS),
        jnp.bfloat16 if bf16 else jnp.float32))(key)
    codes = None if codes is None else torch.from_numpy(
        np.asarray(codes, np.int64))
    draws = {k: torch.tensor(np.asarray(v)) for k, v in draws.items()}
    for name in ("radiation_gate", "mixture_gate"):
        if name in draws:            # the key makes some gates fire
            p = patches.RADIATION_P if name[0] == "r" else patches.MIXTURE_P
            assert 0 < int((draws[name] < p).sum()) < BATCH
    got = tp.make_batch(None, torch.from_numpy(centers), codes=codes,
                        draws=draws)
    w1 = np.asarray(want[0]).astype(np.float32)
    # either noise's float32 weights promote a bf16 patch to float32
    assert got[0].dtype == torch.float32 and want[0].dtype == jnp.float32
    atol = ATOL + (patches.BETA * 2.0 ** -8 * max(
        float(draws[k].abs().max()) for k in draws if k.endswith("noise"))
        if bf16 else 0.0)
    np.testing.assert_allclose(got[0].float().numpy(), w1, rtol=RTOL,
                               atol=atol)
    np.testing.assert_array_equal(got[1].float().numpy(),
                                  np.asarray(want[1]).astype(np.float32))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_noise_draws_have_the_reference_distributions():
    img1, img2, gt = _scene()
    pipe = patches.PatchPipeline(
        img1, img2, gt, P, [0], K,
        augment=patches.AugmentConfig(radiation=True, mixture=True))
    g = torch.Generator().manual_seed(0)
    n = 4096
    d = pipe.draw_noise(g, (n, P, P, BANDS))
    for name, p in (("radiation_gate", 0.1), ("mixture_gate", 0.2)):
        rate = float((d[name] < p).float().mean())
        assert abs(rate - p) <= 4 * np.sqrt(p * (1 - p) / n), (name, rate)
    a = d["radiation_alpha"]
    assert 0.9 <= float(a.min()) and float(a.max()) < 1.1
    assert abs(float(a.mean()) - 1.0) < 0.01
    m = d["mixture_alpha"]
    assert m.shape == (n, 2) and 0.01 <= float(m.min()) and float(m.max()) < 1
    assert d["mixture_pick"].shape == (n, P, P)
    for name in ("radiation_noise", "mixture_noise"):
        x = d[name]
        assert x.shape == (n, P, P, BANDS)
        assert abs(float(x.mean())) < 0.01 and abs(float(x.std()) - 1) < 0.01


def test_radiation_noise_applies_to_a_tenth_of_the_batch():
    """The JAX suite's check (tests/test_pipeline.py), on the port's own
    draws: the batch differs from the raw gather in ~10% of samples."""
    img1, img2, gt = _scene()
    pipe = patches.PatchPipeline(
        img1, img2, gt, P, [0], K,
        augment=patches.AugmentConfig(radiation=True))
    centers = torch.from_numpy(pipe.indices[:200])
    base = pipe.make_batch(None, centers, train=False)[0]
    aug = pipe.make_batch(torch.Generator().manual_seed(1), centers)[0]
    changed = (base != aug).flatten(1).any(dim=1).float().mean()
    assert 0.02 < float(changed) < 0.3


def test_cli_trains_with_both_noises(tmp_path, monkeypatch):
    for k, v in (("H", "20"), ("W", "24"), ("BANDS", "8"), ("CLASSES", "4")):
        monkeypatch.setenv("VCT_SYN_" + k, v)
    monkeypatch.chdir(tmp_path)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        args = cli.build_parser().parse_args([
            "--dataset", "Synthetic", "--device", "cpu", "--model",
            "Early_fusion_CNN", "--runs", "1", "--epoch", "2",
            "--batch_size", "32", "--training_sample", "30",
            "--infer_chunk", "128", "--log_every", "0",
            "--flip_augmentation", "--radiation_augmentation",
            "--mixture_augmentation", "--bf16"])
        (result,) = cli.run_experiments(args)
    finally:
        torch.set_num_threads(threads)
    assert result["epochs"] == 2 and np.isfinite(result["losses"]).all()
