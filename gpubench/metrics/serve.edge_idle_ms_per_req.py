"""Device idle milliseconds a request outside every ``fullscene.band``
range of the traced span (the scene's lookup, the map's allocation and
download, the request's edges), over the traced requests'
``fullscene.map`` ranges; the profiler's own idle time left out. With
``serve.band_idle_ms_per_band`` times the bands it adds up to the traced
span's idle time (:mod:`gpubench.spans`)."""

from gpubench import spans


def read(ctx):
    t = ctx["trace"]
    maps = spans.intervals(t, spans.MAP)
    bands = spans.intervals(t, spans.BAND)
    if not maps or not bands or not t.device_ops:
        return None
    return 1e3 * spans.edge_idle_s(t, bands) / len(maps)
