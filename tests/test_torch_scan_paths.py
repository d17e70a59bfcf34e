"""The port's copy of ops/scan_paths.py (vit_cnn_tpu_torch/ops/scan_paths.py,
numpy-only, copied because vit_cnn_tpu.ops's package init imports jax)
must stay equal to the JAX package's: same file, same orderings."""

import dataclasses
import os

import numpy as np
import pytest

from vit_cnn_tpu.ops import scan_paths as jax_paths
from vit_cnn_tpu_torch.ops import scan_paths as port_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQUENCE = ["forward", "shuffle", "forward_reverse_mean",
            "forward_reverse_gate", "forward_reverse_shuffle_gate",
            "forward_reverse_shuffle_mean"]


def test_copy_is_byte_identical():
    with open(os.path.join(ROOT, "vit_cnn_tpu", "ops", "scan_paths.py"),
              "rb") as a, open(os.path.join(
                  ROOT, "vit_cnn_tpu_torch", "ops", "scan_paths.py"),
                  "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("tokens", [81, 49])
@pytest.mark.parametrize("kind", ["{}_2+8", "eight_directions_gate",
                                  "{}twoclock"] + SEQUENCE)
def test_orderings_and_bases_equal(kind, tokens):
    path = kind.format(tokens)
    want = jax_paths.path_orderings(path, tokens)
    got = port_paths.path_orderings(path, tokens)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    w_orders, w_bases, w_fwd, w_rev = jax_paths.base_paths(path, tokens)
    g_orders, g_bases, g_fwd, g_rev = port_paths.base_paths(path, tokens)
    assert (g_bases, g_fwd, g_rev) == (w_bases, w_fwd, w_rev)
    assert (dataclasses.asdict(port_paths.path_spec(path))
            == dataclasses.asdict(jax_paths.path_spec(path)))
    for o in got:
        np.testing.assert_array_equal(port_paths.inverse_permutation(o),
                                      jax_paths.inverse_permutation(o))
