"""Device idle milliseconds a step while the host was inside the
program's ``trainer.step`` ranges (``Trainer._step``: batch, forward and
loss, backward, optimizer), over the traced epochs' steps; the
profiler's own idle time left out (:mod:`gpubench.spans`)."""

from gpubench import spans


def read(ctx):
    t = ctx["trace"]
    steps = spans.intervals(t, spans.STEP)
    if not steps or not t.device_ops:
        return None
    return 1e3 * spans.idle_s(t, steps) / len(steps)
