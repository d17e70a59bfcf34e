"""Device idle milliseconds an epoch outside every ``trainer.step``
range of the traced span (the epoch's order, its upload, the loss read),
over the traced epochs (``work["traced"]["epochs"]``); the profiler's
own idle time left out. With ``train.step_idle_ms_per_step`` times the
steps it adds up to the traced span's idle time
(:mod:`gpubench.spans`)."""

from gpubench import spans


def read(ctx):
    t, w = ctx["trace"], ctx["work"]["traced"]
    steps = spans.intervals(t, spans.STEP)
    if not steps or not w.get("epochs") or not t.device_ops:
        return None
    return 1e3 * spans.edge_idle_s(t, steps) / w["epochs"]
