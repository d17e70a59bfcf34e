"""The PyTorch port's Mamba backbone and flagship against the JAX package.

Seeded random values for every parameter and BatchNorm statistic go into
the flax modules and, through vit_cnn_tpu_torch.convert, into the port;
the same numpy inputs go through both. On the CPU in float32 the JAX
layer runs its generic formulation and the port its lane-major one with
the kernels' plain versions.

Tolerance: the JAX suite's float32 op tolerance, rtol 2e-4 / atol 2e-5.
Both sides are float32 but sum in different orders (the JAX associative
scan against the port's sequential one, XLA's matmuls against torch's);
observed max differences are 2.5e-7 on logits of magnitude 0.8 and
1.3e-6 on backbone features of magnitude 4.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_cnn_tpu.models.mm_mamba import MultimodalityMamba as JaxFlagship
from vit_cnn_tpu.nn.mamba import DirectionalMambaBackbone as JaxBackbone
from vit_cnn_tpu_torch.convert import (flax_to_state_dict, seeded_variables,
                                       state_dict_to_flax)
from vit_cnn_tpu_torch.models.mm_mamba import MultimodalityMamba
from vit_cnn_tpu_torch.nn.mamba import DirectionalMambaBackbone

RTOL, ATOL = 2e-4, 2e-5
P, BANDS, LIDAR, K, BATCH = 9, 20, 1, 6, 4


def _paths(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = tuple(np.shape(v))
    return out


def _port(model, tree):
    model.load_state_dict(flax_to_state_dict(tree, model))
    return model.eval()


@pytest.fixture(scope="module")
def flagship():
    jm = JaxFlagship(img_size=P, in_channels1=BANDS, in_channels2=LIDAR,
                     dim_embedding=32, n_classes=K)
    key = jax.random.PRNGKey(0)
    # the variable tree's structure and shapes, without running the init
    init = flax.core.unfreeze(jax.eval_shape(lambda: jm.init(
        {"params": key, "dropout": key}, jnp.zeros((2, P, P, BANDS)),
        jnp.zeros((2, P, P, LIDAR)), train=False)))
    tree = seeded_variables(init, seed=0)
    apply = jax.jit(lambda v, a, b: jm.apply(v, a, b, train=False))
    rng = np.random.RandomState(1)
    hsi = rng.rand(BATCH, P, P, BANDS).astype(np.float32)
    lidar = rng.rand(BATCH, P, P, LIDAR).astype(np.float32)
    return init, tree, apply, hsi, lidar


def _port_logits(tree, hsi, lidar):
    tm = _port(MultimodalityMamba(P, BANDS, LIDAR, 32, K), tree)
    with torch.no_grad():
        return tm(torch.from_numpy(hsi), torch.from_numpy(lidar)).numpy()


def test_port_tree_is_the_flax_tree(flagship):
    init, _, _, _, _ = flagship
    tm = MultimodalityMamba(P, BANDS, LIDAR, 32, K)
    assert _paths(state_dict_to_flax(tm)) == _paths(init)


def test_convert_round_trip_and_strictness(flagship):
    _, tree, _, _, _ = flagship
    tm = _port(MultimodalityMamba(P, BANDS, LIDAR, 32, K), tree)
    back = flax_to_state_dict(state_dict_to_flax(tm), tm)
    for key, t in tm.state_dict().items():
        assert torch.equal(back[key], t), key
    extra = seeded_variables(tree, 0)
    extra["params"]["classifier"]["stray"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="stray"):
        flax_to_state_dict(extra, tm)
    short = seeded_variables(tree, 0)
    del short["batch_stats"]["lidar1"]
    with pytest.raises(KeyError, match="left unset"):
        flax_to_state_dict(short, tm)


def test_flagship_matches_jax(flagship):
    _, tree, apply, hsi, lidar = flagship
    want = np.asarray(apply(tree, hsi, lidar))
    got = _port_logits(tree, hsi, lidar)
    assert got.shape == (BATCH, K)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_nonlocal_output_reaches_the_logits(flagship):
    """With NonLocal's output BN scale zeroed (its init value) the
    attention cannot reach the logits; the seeded scale must make a
    difference, and the port must match JAX in both cases."""
    _, tree, apply, hsi, lidar = flagship
    cut = seeded_variables(tree, 0)
    for blk in ("hsi1", "hsi2"):
        w_bn = cut["params"][blk]["gl_fusion"]["cross_attention"]["W_bn"]
        w_bn["scale"] = np.zeros_like(w_bn["scale"])
    full = np.asarray(apply(tree, hsi, lidar))
    without = np.asarray(apply(cut, hsi, lidar))
    assert np.abs(full - without).max() > 1e-2
    np.testing.assert_allclose(_port_logits(cut, hsi, lidar), without,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("img,path", [
    (9, "81_2+8"), (7, "49_2+8"), (5, "eight_directions_gate"),
    (5, "forward_reverse_mean")])
def test_backbone_matches_jax(img, path):
    embed, ff, ch, layers = 16, 8, 12, 2
    jb = JaxBackbone(embed_dims=embed, num_layers=layers,
                     feedforward_channels=ff, img_size=img, in_channels=ch,
                     path_type=path)
    x = np.random.RandomState(2).randn(3, img, img, ch).astype(np.float32)
    init = jax.eval_shape(jb.init, jax.random.PRNGKey(0), jnp.asarray(x))
    tree = seeded_variables(flax.core.unfreeze(init), seed=3)
    want = np.asarray(jax.jit(jb.apply)(tree, x))
    tb = _port(DirectionalMambaBackbone(embed, layers, ff, img, ch,
                                        path_type=path), tree)
    with torch.no_grad():
        got = tb(torch.from_numpy(x)).numpy()
    assert got.shape == (3, img, img, embed)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
