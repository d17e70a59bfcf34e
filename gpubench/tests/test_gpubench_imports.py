"""What the benchmark loads, by the top-level name of each module (the part
before the first dot, compared whole: the port's name begins with the JAX
package's)."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from gpubench import layout
from gpubench.run import FORBIDDEN, forbidden_modules

CELLS = [w["name"] for w in layout.benchmark()["workloads"]]
CONFIGS = [c["name"] for c in layout.benchmark()["configs"]]


def loaded_after(code: str) -> set:
    """Top-level names of the modules a fresh interpreter holds after
    ``code`` (run from the checkout's root)."""
    script = code + textwrap.dedent("""
        import json, sys
        print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
        """)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", script], cwd=layout.ROOT,
                         capture_output=True, text=True, timeout=600,
                         check=True, env=env)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_top_level_names_are_compared_whole():
    assert forbidden_modules(["vit_cnn_tpu_torch", "vit_cnn_tpu_torch.nn",
                              "jaxtyping", "flaxen"]) == []
    assert forbidden_modules(["vit_cnn_tpu.models", "jax", "flax.linen",
                              "jaxlib.xla_client"]) == [
        "flax.linen", "jax", "jaxlib.xla_client", "vit_cnn_tpu.models"]


@pytest.mark.parametrize("name", CELLS)
def test_a_cell_loads_no_jax(name):
    names = loaded_after(textwrap.dedent("""
        from gpubench.testing import run_small
        from gpubench import control
        run_small({name!r}, trace=True)
        control.readings({name!r}, 5, "fp8", device="cpu",
                         info=__import__("gpubench.testing").testing.small(
                             {name!r}))
        """.format(name=name)))
    assert "vit_cnn_tpu_torch" in names
    assert not names & set(FORBIDDEN), names & set(FORBIDDEN)


@pytest.mark.parametrize("config", CONFIGS)
def test_reference_and_counts_load_nothing_of_the_program(config):
    names = loaded_after(textwrap.dedent("""
        import torch
        from gpubench import layout
        ref = layout.module("reference", {config!r})
        counts = layout.module("counts", {config!r})
        """.format(config=config)))
    assert not names & ({"vit_cnn_tpu_torch"} | set(FORBIDDEN))
