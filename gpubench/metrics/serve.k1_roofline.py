"""K1's share of its roofline over the traced requests: K1's least time
for every band served (``counts/<config>.py`` ``K1_LEAST_S_PER_BAND``
times the traced bands) over the device time of the K1 family's kernels
(``selective_scan_fwd_kernel``)."""


def read(ctx):
    t, w = ctx["trace"], ctx["work"]["traced"]
    least = getattr(ctx["counts"], "K1_LEAST_S_PER_BAND", None)
    spent = t.family_seconds().get("K1 scan forward", 0.0)
    if least is None or not w.get("bands") or spent <= 0:
        return None
    return 100.0 * least * w["bands"] / spent
