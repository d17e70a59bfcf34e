"""The transformer zoo's layers in the port against flax, on seeded numpy
inputs, with flax's variables carried across by vit_cnn_tpu_torch.convert:
the ViT backbone in 'ViT' and 'CAF' wiring, PyConv, the general Conv (3-D
with strides and per-dim padding as in MHST's stem, the 1-D conv of
S2EFT's gate, grouped 2-D), LayerNorm's per-instance epsilon, the tanh
GELU, and GLT_Net's resizes (bilinear and nearest upsampling by 2 and 3,
edges included).

Tolerance: the JAX suite's float32 op tolerance, rtol 2e-4 / atol 2e-5.
"""

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_cnn_tpu.nn.pyconv import PyConv as JaxPyConv
from vit_cnn_tpu.nn.transformer import ViTBackbone as JaxViTBackbone
from vit_cnn_tpu_torch.convert import flax_to_state_dict, seeded_variables
from vit_cnn_tpu_torch.models.glt_net import resize
from vit_cnn_tpu_torch.nn.layers import Conv, LayerNorm, gelu
from vit_cnn_tpu_torch.nn.pyconv import PyConv
from vit_cnn_tpu_torch.nn.transformer import ViTBackbone

RTOL, ATOL = 2e-4, 2e-5


def _both(jax_module, port_module, x, seed=0):
    """Seeded variables for the flax module, carried into the port module;
    both applied to x."""
    init = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0),
                          jnp.asarray(x))
    tree = seeded_variables(flax.core.unfreeze(init), seed)
    want = np.asarray(jax.jit(jax_module.apply)(tree, x))
    port_module.load_state_dict(flax_to_state_dict(tree, port_module))
    with torch.no_grad():
        got = port_module.eval()(torch.from_numpy(x)).numpy()
    return got, want


@pytest.mark.parametrize("mode,depth,n", [("ViT", 2, 65), ("CAF", 4, 145),
                                          ("ViT", 1, 146)])
def test_vit_backbone_matches_flax(mode, depth, n):
    x = np.random.RandomState(n).randn(2, n, 64).astype(np.float32)
    got, want = _both(
        JaxViTBackbone(64, depth, 4, 16, 8, mode=mode, num_tokens=n),
        ViTBackbone(64, depth, 4, 16, 8, mode=mode, num_tokens=n), x)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_vit_backbone_decoder_width_matches_flax():
    """GLT_Net's decoder: dim 32 with 4 heads of 16 (inner width 64)."""
    x = np.random.RandomState(2).randn(3, 65, 32).astype(np.float32)
    got, want = _both(JaxViTBackbone(32, 2, 4, 16, 8),
                      ViTBackbone(32, 2, 4, 16, 8), x)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_vit_backbone_wide_heads_take_the_folded_route():
    """dim_head >= 32 goes through the folded attention (K4's path)."""
    x = np.random.RandomState(3).randn(2, 9, 64).astype(np.float32)
    got, want = _both(JaxViTBackbone(64, 1, 2, 32, 16),
                      ViTBackbone(64, 1, 2, 32, 16), x)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cfg", [
    (64, 64, (3, 5, 7, 9), (4, 4, 4, 4), (1, 2, 4, 8)),     # MHST conv4
    (1, 32, (3, 5, 7, 9), (4, 4, 4, 4), (1, 1, 1, 1)),      # LiDAR conv1
    (64, 32, (3, 5), (2, 2), (2, 2))])                      # cls_conv1
def test_pyconv_matches_flax(cfg):
    cin, planes, kernels, divs, groups = cfg
    x = np.random.RandomState(cin).rand(2, 8, 8, cin).astype(np.float32)
    got, want = _both(JaxPyConv(planes, kernels, divs, groups),
                      PyConv(cin, planes, kernels, divs, groups), x)
    assert got.shape == (2, 8, 8, planes)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("flax_conv,port_conv,shape", [
    # MHST's stem: 3-D, stride 3 along the bands, padding (5, 1, 1)
    (fnn.Conv(16, (11, 3, 3), strides=(3, 1, 1),
              padding=((5, 5), (1, 1), (1, 1))),
     Conv(1, 16, (11, 3, 3), strides=(3, 1, 1), padding=(5, 1, 1)),
     (2, 22, 8, 8, 1)),
    # MHST's band inception branch and 3x3x3 conv
    (fnn.Conv(4, (5, 1, 1), padding=(2, 0, 0)),
     Conv(16, 4, (5, 1, 1), padding=(2, 0, 0)), (2, 8, 8, 8, 16)),
    (fnn.Conv(16, (3, 3, 3), padding=1), Conv(16, 16, (3, 3, 3), padding=1),
     (2, 8, 8, 8, 16)),
    # S2EFT's gate: a 1-D conv over the bands, flax kernel (7, 2, 1)
    (fnn.Conv(1, (7,), padding=3), Conv(2, 1, (7,), padding=3), (3, 20, 2)),
    # grouped 2-D: flax kernel (kh, kw, in / groups, out)
    (fnn.Conv(12, (3, 3), padding=1, feature_group_count=4),
     Conv(8, 12, 3, padding=1, groups=4), (2, 6, 6, 8)),
    # the valid 2-D conv and the 1x1 conv of the flagship
    (fnn.Conv(5, (3, 3), padding="VALID"), Conv(4, 5, 3), (2, 7, 7, 4)),
    (fnn.Conv(5, (1, 1)), Conv(4, 5, 1), (2, 7, 7, 4)),
])
def test_conv_matches_flax(flax_conv, port_conv, shape):
    x = np.random.RandomState(len(shape)).randn(*shape).astype(np.float32)
    got, want = _both(flax_conv, port_conv, x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_layer_norm_epsilon_is_per_instance(eps):
    """Zero-mean inputs of variance ~1e-6, where the two epsilons give
    results ~30% apart."""
    x = (1e-3 * np.random.RandomState(4).randn(3, 7, 16)).astype(np.float32)
    got, want = _both(fnn.LayerNorm(epsilon=eps), LayerNorm(16, eps=eps), x)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    other, _ = _both(fnn.LayerNorm(epsilon=eps),
                     LayerNorm(16, eps=1e-5 if eps == 1e-6 else 1e-6), x)
    assert np.abs(other - want).max() > 1e-2


def test_gelu_is_flax_gelu():
    x = np.linspace(-6, 6, 241, dtype=np.float32)
    np.testing.assert_allclose(gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(fnn.gelu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode,jax_mode", [("bilinear", "bilinear"),
                                           ("nearest-exact", "nearest")])
@pytest.mark.parametrize("scale", [2, 3])
def test_resize_matches_jax_image_resize(mode, jax_mode, scale):
    x = np.random.RandomState(scale).rand(2, 8, 8, 3).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x),
                                       (2, 8 * scale, 8 * scale, 3),
                                       jax_mode))
    got = resize(torch.from_numpy(x), 8 * scale, mode).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
