"""The V4 kind of the kernel-ablation tool (``tools/kernel_ablation.py
outer``): its command line, and that its cases are the attention sweep's
shapes run through V4's C entry point."""

import pytest

from vit_cnn_tpu_torch.ops import _build
from vit_cnn_tpu_torch.tools import heads_attn_variants, kernel_ablation


@pytest.mark.parametrize("argv", [["outer", "heads_variants.cu"],
                                  ["outer", "old/heads_variants.cu",
                                   "new/heads_variants.cu"]])
def test_outer_kind_parses(argv):
    kind, srcs = kernel_ablation.parse_args(argv)
    assert kind == "outer"
    assert [p.name for p in srcs] == ["heads_variants.cu"] * (len(argv) - 1)


def test_outer_kind_refuses_no_sources():
    with pytest.raises(SystemExit, match=r"outer\|scan\|conv"):
        kernel_ablation.parse_args(["outer"])


def test_outer_cases_are_the_sweep_shapes():
    """V4's ablation times the four shapes the attention sweep reports,
    through ``vct_heads_attention_outer`` (its kernel named as ptxas
    names it)."""
    assert kernel_ablation.OUTER_CASES == heads_attn_variants.SHAPES
    entry, kernel = kernel_ablation.KINDS["outer"]
    assert entry == "vct_heads_attention_outer" and entry in _build._SIGNATURES
    assert kernel == "heads_outer_kernel"
    assert kernel_ablation.CASES["outer"] == (kernel_ablation.OUTER_CASES,
                                              kernel_ablation.outer_case)
