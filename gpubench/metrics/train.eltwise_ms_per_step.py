"""Device milliseconds of the elementwise / copy / cast family per train
step of the traced epochs."""


def read(ctx):
    t, w = ctx["trace"], ctx["work"]["traced"]
    spent = t.family_seconds().get("elementwise/copy/cast", 0.0)
    if not w.get("steps") or spent <= 0:
        return None
    return 1e3 * spent / w["steps"]
