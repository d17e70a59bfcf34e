"""Device milliseconds of the elementwise / copy / cast family per 1,000
windows of the traced requests."""


def read(ctx):
    t, w = ctx["trace"], ctx["work"]["traced"]
    spent = t.family_seconds().get("elementwise/copy/cast", 0.0)
    if not w.get("windows") or spent <= 0:
        return None
    return 1e3 * spent / (w["windows"] / 1e3)
