"""The convolutions' share of their roofline over the traced requests:
the counted convolution FLOPs (``CONV_FLOPS_PER_WINDOW`` times the traced
windows; every band, the padded last one included, runs whole) at the
bf16 dense peak, over the device time of the conv family (cuDNN)."""

from gpubench.peaks import PEAK_FLOPS


def read(ctx):
    t, w = ctx["trace"], ctx["work"]["traced"]
    flops = getattr(ctx["counts"], "CONV_FLOPS_PER_WINDOW", None)
    spent = t.family_seconds().get("conv", 0.0)
    if flops is None or not w.get("computed_windows") or spent <= 0:
        return None
    return (100.0 * flops * w["computed_windows"] / PEAK_FLOPS["bfloat16"]
            / spent)
