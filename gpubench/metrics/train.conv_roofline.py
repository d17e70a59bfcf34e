"""The convolutions' share of their roofline over the traced epochs: the
counted forward and adjoint convolution FLOPs a patch
(``CONV_TRAIN_FLOPS_PER_PATCH``) times every patch stepped, padding
included, at the bf16 dense peak, over the device time of the conv
family (cuDNN)."""

from gpubench.peaks import PEAK_FLOPS


def read(ctx):
    t, w = ctx["trace"], ctx["work"]["traced"]
    flops = getattr(ctx["counts"], "CONV_TRAIN_FLOPS_PER_PATCH", None)
    spent = t.family_seconds().get("conv", 0.0)
    if flops is None or not w.get("patches") or spent <= 0:
        return None
    return 100.0 * flops * w["patches"] / PEAK_FLOPS["bfloat16"] / spent
