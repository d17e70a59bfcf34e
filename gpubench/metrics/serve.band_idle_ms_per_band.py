"""Device idle milliseconds a band while the host was inside the
program's ``fullscene.band`` ranges (each band of the stride-1 loop:
``band_patches``, the model, the masked add into the map), over the
traced request's bands; the profiler's own idle time left out
(:mod:`gpubench.spans`)."""

from gpubench import spans


def read(ctx):
    t = ctx["trace"]
    bands = spans.intervals(t, spans.BAND)
    if not bands or not t.device_ops:
        return None
    return 1e3 * spans.idle_s(t, bands) / len(bands)
