"""The port stands alone: no module of vit_cnn_tpu_torch, and not
chip_smoke.py, imports jax, flax or the JAX package vit_cnn_tpu (not even
its numpy-only modules), nor scikit-learn, msgpack, PIL or matplotlib,
which the GPU host lacks; so the port ships without the JAX tree. Its own
copies of the dataset registry, the loaders, the sampling helpers, the
metrics, the report and the palette give what the JAX package's give: the
Synthetic scene and a .mat scene bit for bit, the metrics and both
sampling helpers exactly, and the report and palette modules are the JAX
files byte for byte.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import scipy.io

from vit_cnn_tpu.data import registry as jax_registry
from vit_cnn_tpu.data import sampling as jax_sampling
from vit_cnn_tpu.metrics import classification as jax_metrics
from vit_cnn_tpu_torch.data import registry, sampling
from vit_cnn_tpu_torch.metrics import classification

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "vit_cnn_tpu", "sklearn", "msgpack",
             "PIL", "matplotlib")
#: the port's byte-identical copies of JAX package modules
COPIES = ("metrics/report.py", "utils/palette.py")


def _port_sources():
    pkg = os.path.join(ROOT, "vit_cnn_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported_modules(tree):
    """Top-level names of every absolute import, at any depth of the file
    (function-local imports included), and of every string handed to
    importlib.import_module or __import__."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str):
            fn = node.func
            name = getattr(fn, "attr", None) or getattr(fn, "id", None)
            if name in ("import_module", "__import__"):
                yield node.args[0].value


def test_source_scan_finds_no_jax_import():
    offenders = []
    for path in _port_sources():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for mod in _imported_modules(tree):
            if mod.split(".")[0] in FORBIDDEN:
                offenders.append("{}: {}".format(os.path.relpath(path, ROOT),
                                                 mod))
    assert not offenders, offenders


def test_every_port_module_imports_without_jax():
    """Every module of the package, found by pkgutil.walk_packages and
    imported in a fresh process, leaves none of jax, flax, vit_cnn_tpu,
    scikit-learn, msgpack, PIL or matplotlib (the last five absent on the
    GPU host) in sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import vit_cnn_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    pkg.__path__, 'vit_cnn_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "print(len(names))\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in {!r}))\n"
    ).format(FORBIDDEN)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=180)
    assert proc.returncode == 0, proc.stderr
    count, loaded = proc.stdout.strip().splitlines()
    assert int(count) >= 30          # every subpackage was walked
    assert loaded == "[]"


def _same(a, b):
    assert type(a) is type(b) or (isinstance(a, np.ndarray)
                                  and isinstance(b, np.ndarray))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_synthetic_scene_is_the_jax_scene(monkeypatch):
    for k, v in (("H", "21"), ("W", "26"), ("BANDS", "12")):
        monkeypatch.setenv("VCT_SYN_" + k, v)
    got = registry.get_dataset("Synthetic", "unused")
    want = jax_registry.get_dataset("Synthetic", "unused")
    assert got[0].shape == (21, 26, 12)
    for g, w in zip(got, want):
        _same(g, w)


def test_synthetic_class_count_is_read_at_load(monkeypatch):
    monkeypatch.setenv("VCT_SYN_CLASSES", "6")
    monkeypatch.setenv("VCT_SYN_H", "10")
    _, _, gt, labels = registry.get_dataset("Synthetic", "unused")[:4]
    assert len(labels) == 6 and gt.max() <= 5


def test_mat_scene_is_the_jax_scene(tmp_path):
    """Houston2013's layout (HSI.mat, LiDAR.mat, gt.mat), a 2-D LiDAR
    raster larger than the HSI and one NaN pixel."""
    rng = np.random.RandomState(0)
    folder = tmp_path / "Houston2013"
    folder.mkdir()
    hsi = 100 * rng.rand(9, 11, 6)
    hsi[3, 4, 2] = np.nan
    scipy.io.savemat(folder / "HSI.mat", {"HSI": hsi})
    scipy.io.savemat(folder / "LiDAR.mat", {"LiDAR": 5 * rng.rand(10, 12)})
    scipy.io.savemat(folder / "gt.mat",
                     {"gt": rng.randint(0, 16, (9, 11)).astype(np.uint8)})
    got = registry.get_dataset("Houston2013", str(tmp_path))
    want = jax_registry.get_dataset("Houston2013", str(tmp_path))
    assert got[2][3, 4] == 0 and got[1].shape == (9, 11, 1)
    for g, w in zip(got, want):
        _same(g, w)


def test_metrics_are_the_jax_metrics():
    rng = np.random.RandomState(3)
    target = rng.randint(0, 7, (30, 40))
    pred = np.where(rng.rand(30, 40) < 0.7, target, rng.randint(0, 7,
                                                                (30, 40)))
    pred[target == 5] = 1                    # class 5 never predicted
    for kw in ({"ignored_labels": [0], "n_classes": 8},
               {"ignored_labels": [0, 2]}):
        got = classification.metrics(pred, target, **kw)
        want = jax_metrics.metrics(pred, target, **kw)
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(np.asarray(got[key]),
                                          np.asarray(want[key]))


def test_sampling_helpers_are_the_jax_helpers():
    gt = np.random.RandomState(4).randint(0, 6, (25, 30))
    for n, seed in ((10, 0), (3, 7)):
        assert sampling.sampling_fixed_num(n, gt.ravel(), seed) == \
            jax_sampling.sampling_fixed_num(n, gt.ravel(), seed)
    for kw in ({}, {"n_classes": 6, "ignored_classes": [0]},
               {"n_classes": 8, "ignored_classes": [0, 3]}):
        np.testing.assert_array_equal(
            sampling.compute_imf_weights(gt, **kw),
            jax_sampling.compute_imf_weights(gt, **kw))


def test_report_and_palette_are_the_jax_files():
    for rel in COPIES:
        with open(os.path.join(ROOT, "vit_cnn_tpu", rel), "rb") as f:
            want = f.read()
        with open(os.path.join(ROOT, "vit_cnn_tpu_torch", rel), "rb") as f:
            assert f.read() == want, rel
