"""The whole model's share of the bf16 dense peak: the counted FLOPs a
window (``counts/<config>.py`` ``FLOPS_PER_WINDOW``) times the windows of
the traced requests, over the traced window (``Trace.window_s``), over
989e12."""

from gpubench.peaks import PEAK_FLOPS


def read(ctx):
    t, w = ctx["trace"], ctx["work"]["traced"]
    flops = getattr(ctx["counts"], "FLOPS_PER_WINDOW", None)
    if flops is None or not w.get("windows") or t.window_s <= 0:
        return None
    return 100.0 * flops * w["windows"] / t.window_s / PEAK_FLOPS["bfloat16"]
