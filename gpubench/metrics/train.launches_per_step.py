"""Kernel launch calls (``cudaLaunchKernel*``, ``cuLaunchKernel*``,
``cudaGraphLaunch``) whose host start lies inside a ``trainer.step``
range, on any thread (the backward launches from autograd's thread),
over the traced epochs' steps (:mod:`gpubench.spans`)."""

from gpubench import spans


def read(ctx):
    t = ctx["trace"]
    steps = spans.intervals(t, spans.STEP)
    if not steps or not t.device_ops:
        return None
    return spans.launches(t, steps) / len(steps)
