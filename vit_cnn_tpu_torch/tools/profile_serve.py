"""Profile full-scene serving on the card, per band, by op family.

  python -m vit_cnn_tpu_torch.tools.profile_serve [MODEL ...]

For each model (default: every registered model; a PCA model's scene is
reduced once, while warming up), bf16 policy, ``--infer_chunk`` 8192: a band is what a request
on the 349 x 1905 scene runs (4 origin rows of 1905 - P + 1 windows). The
script serves the top rows of the scene that hold exactly ``BANDS`` such
bands: once to warm up and upload the scene, once on the host clock
without the profiler, once under ``torch.profiler``. One JSON line per
model:

* ``host_ms_per_band`` (unprofiled, synchronized), ``windows_per_s``
  at that rate and ``request_s_at_this_rate`` (that times the request's
  band count);
* ``device_ms_per_band``: kernel time of the profiled run, and ``busy``:
  that over the unprofiled host ms per band;
* ``families``: [family, device ms per band, share, launches per band].

Then each model's 12 kernels with the most device time.
"""

from __future__ import annotations

import collections
import json
import sys
import time

import torch

from . import SCENE, card_line, load_scene
from .profile_train import _device_us, family

BANDS = 4
CHUNK = 8192


def _serve_ms(model, img1, img2, hp, cache) -> float:
    from ..infer.fullscene import full_scene_probabilities

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full_scene_probabilities(model, img1, img2, hp, chunk=CHUNK, cache=cache)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def profile_model(name, scene) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from ..convert import seeded_state_dict
    from ..infer.fullscene import SceneCache
    from ..models.registry import get_model

    img1, img2, _ = scene
    model, _, hp = get_model(name, n_classes=int(SCENE["VCT_SYN_CLASSES"]),
                             n_bands=(img1.shape[2], img2.shape[2]))
    model.load_state_dict(seeded_state_dict(model, 0))
    model.to("cuda").eval()
    p = hp["patch_size"]
    wc = img1.shape[1] - p + 1
    rows = CHUNK // wc
    bands_per_request = -(-(img1.shape[0] - p + 1) // rows)
    top = rows * BANDS + p - 1          # exactly BANDS bands, no padding
    img1, img2 = img1[:top], img2[:top]
    hp = dict(hp, bf16=True)
    cache = SceneCache()
    _serve_ms(model, img1, img2, hp, cache)
    host_ms = _serve_ms(model, img1, img2, hp, cache) / BANDS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _serve_ms(model, img1, img2, hp, cache)
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    ms = collections.Counter()
    launches = collections.Counter()
    for e in kernels:
        ms[family(e.key)] += _device_us(e) / 1e3 / BANDS
        launches[family(e.key)] += e.count / BANDS
    device_ms = sum(ms.values())
    top_kernels = sorted(kernels, key=_device_us, reverse=True)[:12]
    return {
        "model": name, "windows_per_band": rows * wc, "bands": BANDS,
        "host_ms_per_band": host_ms,
        "windows_per_s": rows * wc / host_ms * 1e3,
        "request_s_at_this_rate": host_ms * bands_per_request / 1e3,
        "device_ms_per_band": device_ms, "busy": device_ms / host_ms,
        "families": [(f, t, t / device_ms, launches[f])
                     for f, t in ms.most_common()],
        "top": [(_device_us(e) / 1e3 / BANDS, e.count / BANDS, e.key[:100])
                for e in top_kernels]}


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ..models.registry import model_names

    names = (sys.argv[1:] if argv is None else argv) or model_names()
    print(card_line(), flush=True)
    scene = load_scene()
    for name in names:
        result = profile_model(name, scene)
        top = result.pop("top")
        print(json.dumps(result), flush=True)
        for t, n, key in top:
            print("  {:9.3f} ms/band {:7.1f} launches  {}".format(t, n, key),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
