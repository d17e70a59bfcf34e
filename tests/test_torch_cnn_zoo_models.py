"""The CNN zoo in the port against the JAX package, eval mode, float32, on
the CPU: EndNet, the four Hong fusion CNNs, S2ENet, FusAtNet, MFT and
HCTnet whole, at their registry widths and patch sizes (1 / 7 / 7 / 7 /
7 / 7 / 11 / 11 / 11) over 12 + 1 bands, seeded variables carried across
by vit_cnn_tpu_torch.convert: the module trees, the outputs (each of
Cross_fusion_CNN's three and EndNet's five); the registry's filled
hyperparameters for every JAX name; ``apply_pca`` against scikit-learn;
the full-scene maps of S2ENet and of HCTnet with PCA against the JAX
function; and the CLI serving a CNN model, and HCTnet with PCA, whose
repeated request finds its reduced scene resident.

Tolerance: the JAX suite's float32 op tolerance, rtol 2e-4 / atol 2e-5.
"""

import io
import json
import tempfile

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.decomposition import PCA

from vit_cnn_tpu.data import normalize as jax_normalize
from vit_cnn_tpu.infer import fullscene as jax_fullscene
from vit_cnn_tpu.models import registry as jax_registry
from vit_cnn_tpu_torch.cli import build_parser, run_serve
from vit_cnn_tpu_torch.convert import (flax_to_state_dict, seeded_variables,
                                       state_dict_to_flax)
from vit_cnn_tpu_torch.data import get_dataset
from vit_cnn_tpu_torch.data.normalize import apply_pca
from vit_cnn_tpu_torch.infer.fullscene import full_scene_probabilities
from vit_cnn_tpu_torch.models import registry

RTOL, ATOL = 2e-4, 2e-5
K = 5
BANDS = (12, 1)
CNN_ZOO = ("EndNet", "Early_fusion_CNN", "Middle_fusion_CNN",
           "Late_fusion_CNN", "Cross_fusion_CNN", "S2ENet", "FusAtNet",
           "MFT", "HCTnet")
# HCTnet's registry default reduces the HSI to 30 PCA components; here it
# is built for the 12 bands it is given (pca_components=12)
HP = {"HCTnet": {"pca_components": BANDS[0]}}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _paths(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = tuple(np.shape(v))
    return out


def _hp(name, n_bands=BANDS):
    return dict(HP.get(name, {}), n_classes=K, n_bands=n_bands)


def _flax_init(name, hsi, lidar, n_bands=BANDS):
    jm = jax_registry.get_model(name, **_hp(name, n_bands))[0]
    key = jax.random.PRNGKey(0)
    init = jax.eval_shape(lambda: jm.init(
        {"params": key, "dropout": key}, jnp.asarray(hsi),
        jnp.asarray(lidar), train=False))
    return jm, flax.core.unfreeze(init)


def _port(name, tree, n_bands=BANDS):
    tm = registry.get_model(name, **_hp(name, n_bands))[0]
    tm.load_state_dict(flax_to_state_dict(tree, tm))
    return tm.eval()


def _inputs(name, batch=4, seed=1):
    p = registry.MODELS[name].patch_size
    rng = np.random.RandomState(seed)
    return (rng.rand(batch, p, p, BANDS[0]).astype(np.float32),
            rng.rand(batch, p, p, BANDS[1]).astype(np.float32))


@pytest.fixture(scope="module", params=CNN_ZOO)
def cnn_model(request):
    name = request.param
    hsi, lidar = _inputs(name)
    jm, init = _flax_init(name, hsi, lidar)
    tree = seeded_variables(init, seed=0)
    want = jax.jit(lambda v, a, b: jm.apply(v, a, b, train=False))(
        tree, hsi, lidar)
    return name, init, _port(name, tree), hsi, lidar, want


def test_port_tree_is_the_flax_tree(cnn_model):
    name, init, tm, _, _, _ = cnn_model
    assert _paths(state_dict_to_flax(tm)) == _paths(init)


def test_model_matches_jax(cnn_model):
    name, _, tm, hsi, lidar, want = cnn_model
    with torch.no_grad():
        got = tm(torch.from_numpy(hsi), torch.from_numpy(lidar))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want) == {"EndNet": 5,
                                     "Cross_fusion_CNN": 3}.get(name, 1)
    assert got[0].shape == (4, K)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("name", sorted(jax_registry.MODELS))
def test_registry_fills_what_the_jax_registry_fills(name):
    """Every JAX registry name resolves in the port, with the same filled
    hyperparameters (HCTnet's PCA policy included)."""
    kw = dict(n_classes=K, n_bands=(144, 1), ignored_labels=[0])
    theirs = jax_registry.get_model(name, **kw)[2]
    ours = registry.get_model(name, **kw)[2]
    assert set(ours) == set(theirs)
    for key, value in theirs.items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(ours[key], value, err_msg=key)
        else:
            assert ours[key] == value and type(ours[key]) is type(value), \
                key
    spec, jax_spec = registry.MODELS[name], jax_registry.MODELS[name]
    assert (spec.apply_pca, spec.pca_components) == \
        (jax_spec.apply_pca, jax_spec.pca_components)


def test_hctnet_takes_its_band_count_from_pca_components():
    first_conv = lambda **kw: registry.get_model(
        "HCTnet", n_classes=K, n_bands=(144, 1), **kw)[0].conv2d.weight.shape
    assert first_conv() == (64, 8 * 28, 3, 3)            # 30 components
    assert first_conv(pca_components=10) == (64, 8 * 8, 3, 3)
    assert first_conv(applyPCA=False) == (64, 8 * 142, 3, 3)


# --------------------------------------------------------------------------
# PCA
# --------------------------------------------------------------------------

def _scene(monkeypatch, h, w, bands, classes=15):
    for k, v in (("H", h), ("W", w), ("BANDS", bands),
                 ("CLASSES", classes)):
        monkeypatch.setenv("VCT_SYN_" + k, str(v))
    with tempfile.TemporaryDirectory() as tmp:
        return get_dataset("Synthetic", tmp)[:3]


def test_apply_pca_matches_scikit_learn(monkeypatch):
    """On the Synthetic scene at 144 bands (40 x 60 pixels), 30
    components: against ``PCA(30, whiten=True).fit_transform`` on the
    float64 pixels (the ``covariance_eigh`` solver) every component within
    1e-5 (float32 output); sklearn's sign convention (the largest entry of
    each component positive) is what makes the components agree."""
    img = _scene(monkeypatch, 40, 60, 144)[0]
    flat = img.reshape(-1, 144).astype(np.float64)
    pca = PCA(30, whiten=True)
    want = pca.fit_transform(flat).reshape(40, 60, 30)
    assert pca._fit_svd_solver == "covariance_eigh"
    got = apply_pca(img, 30)
    assert got.dtype == np.float32 and got.shape == (40, 60, 30)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    flipped = apply_pca(-img, 30)            # same components, signs fixed
    np.testing.assert_allclose(flipped, -got, rtol=0, atol=1e-5)


def test_apply_pca_against_the_jax_package(monkeypatch):
    """The JAX package's apply_pca runs scikit-learn on float32 pixels.
    The Synthetic scene's spectrum has 14 separated components, then a
    noise continuum whose neighbouring eigenvalues lie within 2% of each
    other, where a float32 covariance picks another basis: the first 14
    components agree within 2e-4, and beyond them both outputs are
    whitened: their covariance is the identity within 1e-5 (the port's,
    in float64) and 1e-3 (scikit-learn's in float32)."""
    img = _scene(monkeypatch, 40, 60, 144)[0]
    got = apply_pca(img, 30).reshape(-1, 30).astype(np.float64)
    want = jax_normalize.apply_pca(img, 30).reshape(-1, 30)
    values = np.linalg.eigvalsh(np.cov(img.reshape(-1, 144).T))[::-1]
    gaps = (values[:30] - values[1:31]) / values[:30]
    assert gaps[13] > 0.5 and gaps[14:].max() < 0.06
    np.testing.assert_allclose(got[:, :14], want[:, :14], rtol=0, atol=2e-4)
    for out, tol in ((got, 1e-5), (want.astype(np.float64), 1e-3)):
        np.testing.assert_allclose(np.cov(out.T), np.eye(30), rtol=0,
                                   atol=tol)


# --------------------------------------------------------------------------
# full scenes and serving
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,chunk", [("S2ENet", 10), ("HCTnet", 7)])
def test_full_scene_map_matches_jax(name, chunk, monkeypatch):
    """A 13 x 14 Synthetic scene of 12 + 1 bands, several bands with padded
    origin rows. HCTnet serves the PCA of the HSI to 4 components: the
    scene's first 4 are separated (the 5th's eigenvalue is within 1% of
    the 6th's), so the port's numpy PCA and the JAX package's
    scikit-learn one give the same features, within 1e-5."""
    img1, img2, _ = _scene(monkeypatch, 13, 14, BANDS[0], K)
    p = registry.MODELS[name].patch_size
    hp = {"patch_size": p, "n_classes": K}
    n_bands = BANDS
    if name == "HCTnet":
        hp.update(applyPCA=True, pca_components=4)
        n_bands = (4, 1)
        np.testing.assert_allclose(apply_pca(img1, 4),
                                   jax_normalize.apply_pca(img1, 4),
                                   rtol=0, atol=1e-5)
    jm = jax_registry.get_model(name, **dict(hp, n_bands=n_bands))[0]
    key = jax.random.PRNGKey(0)
    init = flax.core.unfreeze(jax.eval_shape(lambda: jm.init(
        {"params": key, "dropout": key},
        jnp.zeros((1, p, p, n_bands[0])), jnp.zeros((1, p, p, 1)),
        train=False)))
    tree = seeded_variables(init, seed=1)
    want = jax_fullscene.full_scene_probabilities(jm, tree, img1, img2, hp,
                                                  chunk=chunk)
    tm = registry.get_model(name, **dict(hp, n_bands=n_bands))[0]
    tm.load_state_dict(flax_to_state_dict(tree, tm))
    got = full_scene_probabilities(tm.eval(), img1, img2, hp, chunk=chunk)
    assert got.shape == (13, 14, K)
    assert np.abs(got[p // 2:13 - p // 2, p // 2:14 - p // 2]).min() > 0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _serve(tmp_path, monkeypatch, model, requests, *extra, bands=12):
    for k, v in (("H", "14"), ("W", "15"), ("BANDS", str(bands)),
                 ("CLASSES", "5")):
        monkeypatch.setenv("VCT_SYN_" + k, v)
    args = build_parser().parse_args([
        "--dataset", "Synthetic", "--folder", str(tmp_path), "--device",
        "cpu", "--model", model, "--infer_chunk", "40", "--serve", *extra])
    out = io.StringIO()
    served = run_serve(args, io.StringIO("".join(
        json.dumps(r) + "\n" for r in requests)), out)
    return served, [json.loads(line) for line in out.getvalue().splitlines()]


@pytest.mark.parametrize("model", ["Cross_fusion_CNN", "EndNet"])
def test_cli_serves_a_cnn_model_on_the_cpu(tmp_path, monkeypatch, model):
    served, (resp,) = _serve(tmp_path, monkeypatch, model, [{}], "--bf16")
    assert served == 1 and resp["ok"] and resp["shape"] == [14, 15, 5]
    assert resp["uploads"] == 2


def test_apply_pca_flag_serves_any_model_on_the_pca():
    """--applyPCA on a model without a PCA default: the registry's 3
    components, the model built for them (as the JAX CLI inits it)."""
    args = build_parser().parse_args(["--applyPCA", "1"])
    assert args.applyPCA is True
    model, _, hp = registry.get_model("Early_fusion_CNN", n_classes=K,
                                      n_bands=(144, 1), applyPCA=True)
    assert hp["pca_components"] == 3 and hp["n_bands"] == (144, 1)
    assert model._Stem_0.ConvBNReLU_0.Conv_0.weight.shape[1] == 3 + 1


def test_cli_serves_hctnet_on_the_pca_and_keeps_it_resident(
        tmp_path, monkeypatch):
    """HCTnet's registry default: the HSI's 30 PCA components (of 40
    bands here). Request 2 uploads nothing: the reduced HSI and the LiDAR
    are resident. An HSI file served by path is reduced once, and reduced
    anew when the file changes on disk."""
    out = tmp_path / "p.npy"
    served, resps = _serve(tmp_path, monkeypatch, "HCTnet",
                           [{"out": str(out)}, {}], bands=40)
    assert served == 2 and all(r["ok"] for r in resps)
    assert [r["uploads"] for r in resps] == [2, 0]
    probs = np.load(out)
    assert probs.shape == (14, 15, 5) and np.isfinite(probs).all()
    assert np.abs(probs[5:9, 5:10]).min() > 0
    img1 = get_dataset("Synthetic", str(tmp_path))[0]
    path = str(tmp_path / "hsi.npy")
    np.save(path, img1)
    rewrite = lambda: np.save(path, img1[::-1].copy())
    reqs = [{"hsi": path, "out": str(out)}, {"hsi": path}]
    served, resps = _serve(tmp_path, monkeypatch, "HCTnet", reqs, bands=40)
    assert [r["uploads"] for r in resps] == [2, 0]
    np.testing.assert_array_equal(np.load(out), probs)
    monkeypatch.setattr("vit_cnn_tpu_torch.infer.server.load_array",
                        _loading_after(rewrite))
    served, resps = _serve(tmp_path, monkeypatch, "HCTnet",
                           reqs + [{"hsi": path, "out": str(out)}], bands=40)
    assert [r["uploads"] for r in resps] == [2, 1, 0]
    assert not np.array_equal(np.load(out), probs)


def _loading_after(rewrite):
    """load_array that rewrites the file after its first load: the
    server's next request finds it changed on disk, reduces it anew, and
    the one after finds it resident."""
    from vit_cnn_tpu_torch.infer.server import load_array

    calls = []

    def load(spec):
        arr = load_array(spec)
        calls.append(spec)
        if len(calls) == 1:
            rewrite()
        return arr

    return load
