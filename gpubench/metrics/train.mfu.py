"""The whole train step's share of the bf16 dense peak: the counted
forward + backward FLOPs a patch (``TRAIN_FLOPS_PER_PATCH``) times the
valid patches of the traced epochs, over the traced window
(``Trace.window_s``), over 989e12."""

from gpubench.peaks import PEAK_FLOPS


def read(ctx):
    t, w = ctx["trace"], ctx["work"]["traced"]
    flops = getattr(ctx["counts"], "TRAIN_FLOPS_PER_PATCH", None)
    if flops is None or not w.get("valid_patches") or t.window_s <= 0:
        return None
    return (100.0 * flops * w["valid_patches"] / t.window_s
            / PEAK_FLOPS["bfloat16"])
