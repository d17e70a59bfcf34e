"""The seeded weights: every model of the port's registry draws, each rule
for the zoo's bare parameters gives ``convert.seeded_variables``' value
for the same draw, the benchmark's configurations draw what they drew
before those rules came, and the serving harness takes each transformer
zoo and fusion model on a small scene."""

import hashlib
import re

import numpy as np
import pytest
import torch

from gpubench import layout, testing, weights

from vit_cnn_tpu_torch.models.registry import MODELS, get_model

#: the leaves of each rule for the zoo's bare parameters, by their key's
#: last component
KINDS = {
    "token": re.compile(r"(cls_token|pos_embedding|encoder_pos_embed|"
                        r"decoder_pos_embed|position_embeddings)$"),
    "mixing": re.compile(r"(token_wA|token_wV|token_wA_L|token_wV_L|"
                         r"dim_reduce)$"),
    "scalar": re.compile(r"(weight_hsi|weight_lidar|vit_cls_coefficient|"
                         r"cnn_cls_coefficient|xishu1|xishu2|coefficient1|"
                         r"coefficient2)$"),
    "skipcat": re.compile(r"skipcat\d+$"),
    "skipcat_bias": re.compile(r"skipcat\d+_bias$"),
}
#: sha256 of each configuration's float32 state at seed 3 on the CPU, in
#: state_dict order, as drawn before the zoo's rules were added
DIGESTS = {
    "mamba-h13":
        "e9f8598f1fff292f7377c2007a719a09681c3be49434d5fa14b0878d058c29af",
    "fusatnet-h13":
        "e39dce1d8471c7efc121dbb8a8f2eba67119d43724c05f9e3f81efc0c5b2f292",
}
#: the zoo models the serving harness is driven with, and the HSI bands
#: each needs: MFT's spectral stem takes 9 taps of the bands and HCTnet
#: reduces them to 30 PCA components, so 8 bands are too few for both
ZOO_BANDS = {"MHST": 8, "GLT_Net": 8, "SpectralFormer": 8, "S2EFT": 8,
             "S2ENet": 8, "MFT": 32, "HCTnet": 32}

_NETS = {}


def net(model, bands=(144, 1), n_classes=16, patch=None):
    key = (model, bands, n_classes, patch)
    if key not in _NETS:
        kw = {} if patch is None else {"patch_size": patch}
        _NETS[key] = get_model(model, n_classes=n_classes, n_bands=bands,
                               ignored_labels=[0], **kw)[0]
    return _NETS[key]


def shapes(module):
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


@pytest.mark.parametrize("model", sorted(MODELS))
def test_every_registry_model_draws(model):
    want = shapes(net(model))
    sd = weights.seeded_state(want, 3, "cpu")
    assert list(sd) == list(want)
    for k, v in sd.items():
        assert tuple(v.shape) == want[k] and v.dtype == torch.float32, k
        assert bool(torch.isfinite(v).all()), k


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_zoo_rule_equals_convert(kind):
    """Every leaf of the kind in the registry: its state_dict shape is the
    flax leaf's, and the rule on a draw is ``seeded_variables``' value on
    a tree of that one leaf, whose first draw is the same."""
    from vit_cnn_tpu_torch.convert import (seeded_variables,
                                           state_dict_to_flax)

    seen = 0
    for model in sorted(MODELS):
        module = net(model)
        tree = state_dict_to_flax(module)["params"]
        for key, shape in shapes(module).items():
            if not KINDS[kind].match(key.rsplit(".", 1)[-1]):
                continue
            path = key.split(".")
            node = tree
            for part in path:
                node = node[part]
            assert node.shape == shape, key
            leaf = {"params": {}}
            at = leaf["params"]
            for part in path[:-1]:
                at = at.setdefault(part, {})
            at[path[-1]] = np.zeros(shape, np.float32)
            got = seeded_variables(leaf, 11)["params"]
            for part in path:
                got = got[part]
            z = torch.from_numpy(np.random.RandomState(11).randn(*shape))
            u = torch.from_numpy(np.random.RandomState(11).rand(*shape))
            mine = weights._leaf(key, shape, z, u).float().numpy()
            np.testing.assert_array_equal(mine, got, err_msg=key)
            seen += 1
    assert seen, kind


@pytest.mark.parametrize("config", sorted(DIGESTS))
def test_benchmark_configs_draw_as_before(config):
    cell = [w["name"] for w in layout.benchmark()["workloads"]
            if w["config"] == config][0]
    cfg = layout.cell(cell)["config"]
    module = net(cfg["model"], (cfg["hsi_bands"], cfg["lidar_bands"]),
                 cfg["n_classes"], cfg["patch_size"])
    h = hashlib.sha256()
    for v in weights.seeded_state(shapes(module), 3, "cpu").values():
        h.update(v.float().contiguous().numpy().tobytes())
    assert h.hexdigest() == DIGESTS[config]


@pytest.mark.parametrize("model", sorted(ZOO_BANDS))
def test_serving_harness_takes_the_zoo(model):
    """Set-up and one whole request of ``fusatnet-h13.serve``'s mix on the
    tests' small scene, in float32, with the model in FusAtNet's place:
    the map is finite, and no entry that no window centre reaches is set."""
    from gpubench.serve import Serve

    torch.set_num_threads(2)
    info = testing.small("fusatnet-h13.serve", precision="float32")
    info["config"].update(model=model, patch_size=MODELS[model].patch_size)
    info["config"]["scene"]["hsi_bands"] = ZOO_BANDS[model]
    gen = Serve(info, 7, "cpu")
    gen.setup()
    gen.request()
    assert bool(np.isfinite(gen.maps[0]).all())
    assert gen.border_nonzero() == [0]
