"""Share of the traced window (whole epochs; ``Trace.window_s``, which
leaves out the device's idle time in the profiler's own operations) in
which no kernel, memcpy or memset ran on the device:
100 (1 - busy / window)."""


def read(ctx):
    t = ctx["trace"]
    if not t.device_ops or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
