"""The transformer zoo in the port against the JAX package, eval mode,
float32, on the CPU (the kernels' plain versions): SpectralFormer, S2EFT,
MHST and GLT_Net whole, at their registry widths and depths (dim 64, 4
heads of 16 in every ViT, MHST's pooled blocks 16 heads of 4, patch sizes
1 / 7 / 8 / 8) with few bands, seeded variables carried across by
vit_cnn_tpu_torch.convert; GLT_Net's con_loss; convert's strict round
trip for every registered model; the full-scene map of MHST and GLT_Net
(a tuple output and an even patch) against the JAX function; and the CLI
serving a zoo model on the CPU.

Tolerance: the JAX suite's float32 op tolerance, rtol 2e-4 / atol 2e-5.

MHST's head selection thresholds sigmoid(logits) at 0.5, so its output
jumps where a logit crosses 0: the inputs here leave every head-select
logit at least 1e-3 away from 0, and the test checks that they do.
"""

import io
import json

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_cnn_tpu.infer import fullscene as jax_fullscene
from vit_cnn_tpu.models import registry as jax_registry
from vit_cnn_tpu_torch.cli import build_parser, run_serve
from vit_cnn_tpu_torch.convert import (flax_to_state_dict,
                                       seeded_state_dict, seeded_variables,
                                       state_dict_to_flax)
from vit_cnn_tpu_torch.data import get_dataset
from vit_cnn_tpu_torch.infer.fullscene import full_scene_probabilities
from vit_cnn_tpu_torch.models import registry

RTOL, ATOL = 2e-4, 2e-5
K = 5
# model -> (HSI bands, LiDAR bands, patch)
ZOO = {"SpectralFormer": (20, 1, 1), "S2EFT": (20, 1, 7),
       "MHST": (22, 1, 8), "GLT_Net": (12, 1, 8)}


def _paths(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = tuple(np.shape(v))
    return out


def _flax_init(name, hsi, lidar):
    jm = jax_registry.get_model(name, n_classes=K, n_bands=(
        hsi.shape[-1], lidar.shape[-1]), patch_size=hsi.shape[1])[0]
    key = jax.random.PRNGKey(0)
    init = jax.eval_shape(lambda: jm.init(
        {"params": key, "dropout": key}, jnp.asarray(hsi),
        jnp.asarray(lidar), train=False))
    return jm, flax.core.unfreeze(init)


def _port(name, tree, n_bands, patch):
    tm = registry.get_model(name, n_classes=K, n_bands=n_bands,
                            patch_size=patch)[0]
    tm.load_state_dict(flax_to_state_dict(tree, tm))
    return tm.eval()


def _inputs(name, batch=4, seed=1):
    n1, n2, p = ZOO[name]
    rng = np.random.RandomState(seed)
    return (rng.rand(batch, p, p, n1).astype(np.float32),
            rng.rand(batch, p, p, n2).astype(np.float32))


@pytest.fixture(scope="module", params=sorted(ZOO))
def zoo_model(request):
    name = request.param
    hsi, lidar = _inputs(name)
    jm, init = _flax_init(name, hsi, lidar)
    tree = seeded_variables(init, seed=0)
    want = jax.jit(lambda v, a, b: jm.apply(v, a, b, train=False))(
        tree, hsi, lidar)
    tm = _port(name, tree, (hsi.shape[-1], lidar.shape[-1]), hsi.shape[1])
    return name, init, tree, tm, hsi, lidar, want


def test_port_tree_is_the_flax_tree(zoo_model):
    name, init, _, tm, _, _, _ = zoo_model
    assert _paths(state_dict_to_flax(tm)) == _paths(init)


def test_model_matches_jax(zoo_model):
    name, _, _, tm, hsi, lidar, want = zoo_model
    records = []
    if name == "MHST":
        for i in range(8):
            getattr(tm, "hsp_block{}".format(i)).head_select \
                .register_forward_hook(lambda m, a, out: records.append(out))
    with torch.no_grad():
        got = tm(torch.from_numpy(hsi), torch.from_numpy(lidar))
    if name == "GLT_Net":
        (got, loss), (want, want_loss) = got, want
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=RTOL)
    assert got.shape == (4, K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    if name == "MHST":
        logits = torch.stack(records)
        assert logits.abs().min() > 1e-3
        assert (logits > 0).any() and (logits < 0).any()


def test_s2eft_gate_both_keeps_and_drops_tokens():
    """The hard 0.4 gate matters on the parity inputs: with the same
    seeded variables some band tokens pass, some are zeroed (so the parity
    test covers both)."""
    hsi, lidar = _inputs("S2EFT")
    tm = registry.get_model("S2EFT", n_classes=K, n_bands=(20, 1),
                            patch_size=7)[0]
    tm.load_state_dict(seeded_state_dict(tm, seed=0))
    tm.eval()
    gates = []
    tm.gate_conv.register_forward_hook(
        lambda m, a, out: gates.append(torch.sigmoid(out)))
    with torch.no_grad():
        tm(torch.from_numpy(hsi), torch.from_numpy(lidar))
    open_ = gates[0] >= 0.4
    assert open_.any() and not open_.all()


@pytest.mark.parametrize("name", sorted(registry.MODELS))
def test_convert_round_trips_every_model_strictly(name):
    """flax -> port -> flax -> port gives every entry back exactly, and an
    unknown variable or a missing one raises, for every registered
    model."""
    n_bands, patch = ((22, 1), 8) if name != "Multimodality_Mamba" \
        else ((20, 1), 9)
    tm = registry.get_model(name, n_classes=K, n_bands=n_bands,
                            patch_size=patch)[0]
    tree = seeded_variables(state_dict_to_flax(tm), seed=3)
    sd = flax_to_state_dict(tree, tm)
    tm.load_state_dict(sd)
    back = flax_to_state_dict(state_dict_to_flax(tm), tm)
    assert back.keys() == sd.keys()
    for key, t in sd.items():
        assert torch.equal(back[key], t), key
    extra = seeded_variables(tree, 0)
    extra["params"]["stray"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="stray"):
        flax_to_state_dict(extra, tm)
    short = seeded_variables(tree, 0)
    short["params"].pop(sorted(short["params"])[0])
    with pytest.raises(KeyError, match="left unset"):
        flax_to_state_dict(short, tm)


def test_convert_picks_the_rule_by_the_owning_module():
    """S2EFT's 1-D gate kernel (7, 2, 1) is a conv kernel because a Conv
    owns it (its shape alone would read as conv1d taps); a kernel under a
    module that takes none raises."""
    tm = registry.get_model("S2EFT", n_classes=K, n_bands=(20, 1),
                            patch_size=7)[0]
    tree = seeded_variables(state_dict_to_flax(tm), seed=4)
    kernel = tree["params"]["gate_conv"]["kernel"]
    assert kernel.shape == (7, 2, 1)
    sd = flax_to_state_dict(tree, tm)
    np.testing.assert_array_equal(sd["gate_conv.weight"].numpy(),
                                  kernel.transpose(2, 1, 0))
    tree["params"]["head_norm"]["kernel"] = kernel
    with pytest.raises(KeyError, match="takes no kernel"):
        flax_to_state_dict(tree, tm)


@pytest.mark.parametrize("name,chunk", [("MHST", 10), ("GLT_Net", 21)])
def test_full_scene_map_matches_jax(name, chunk, monkeypatch):
    """A 13 x 14 Synthetic scene: 6 x 7 windows of patch 8, centers at
    offset 4, several bands with padded origin rows."""
    n1, n2, p = ZOO[name]
    for k, v in (("H", "13"), ("W", "14"), ("BANDS", str(n1)),
                 ("CLASSES", str(K))):
        monkeypatch.setenv("VCT_SYN_" + k, v)
    img1, img2 = get_dataset("Synthetic", "unused")[:2]
    jm, init = _flax_init(name, img1[None, :p, :p], img2[None, :p, :p])
    tree = seeded_variables(init, seed=1)
    hp = {"patch_size": p, "n_classes": K}
    want = jax_fullscene.full_scene_probabilities(jm, tree, img1, img2, hp,
                                                  chunk=chunk)
    got = full_scene_probabilities(_port(name, tree, (n1, n2), p), img1,
                                   img2, hp, chunk=chunk)
    assert got.shape == (13, 14, K)
    assert np.abs(got[p // 2:13 - p // 2 + 1, p // 2:14 - p // 2 + 1]
                  ).min() > 0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _args(tmp_path, monkeypatch, model, *extra):
    for k, v in (("H", "12"), ("W", "13"), ("BANDS", "10"),
                 ("CLASSES", "5")):
        monkeypatch.setenv("VCT_SYN_" + k, v)
    return build_parser().parse_args([
        "--dataset", "Synthetic", "--folder", str(tmp_path), "--device",
        "cpu", "--model", model, *extra])


@pytest.mark.parametrize("model", sorted(ZOO))
def test_cli_serves_a_zoo_model_on_the_cpu(tmp_path, monkeypatch, model):
    args = _args(tmp_path, monkeypatch, model, "--bf16", "--infer_chunk",
                 "40", "--serve")
    out = io.StringIO()
    served = run_serve(args, io.StringIO('{}\n{"cmd": "quit"}\n'), out)
    (resp,) = [json.loads(line) for line in out.getvalue().splitlines()]
    assert served == 1 and resp["ok"] and resp["shape"] == [12, 13, 5]
