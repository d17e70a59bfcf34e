"""Kernel launch calls (``cudaLaunchKernel*``, ``cuLaunchKernel*``,
``cudaGraphLaunch``) whose host start lies inside a ``fullscene.band``
range, over the traced request's bands (:mod:`gpubench.spans`)."""

from gpubench import spans


def read(ctx):
    t = ctx["trace"]
    bands = spans.intervals(t, spans.BAND)
    if not bands or not t.device_ops:
        return None
    return spans.launches(t, bands) / len(bands)
