"""Sweep of the selective-scan forward's variants on the card.

  python -m vit_cnn_tpu_torch.tools.scan_sweep

The card's form of the JAX package's probes ``perf/scan_sweep.py`` (the
TPU kernel's time chunk and tile) and ``perf/scan_bm_sweep.py`` (the scan
reading the mixer's batch-major layout). In each case (:data:`CASES`), in
bf16 and float32, it times with CUDA-event medians:

* ``K1``: the main path's kernel (ops/selective_scan.py,
  csrc/selective_scan_fwd.cu);
* ``V1 rows=R chunk=T``: every instance of the grid of K1's own kernel
  template, R channels per block (4 warps x 1, 2 or 4 a thread) by T
  staged time steps (ops/scan_variants.py ``selective_scan_tiled``); its
  instance at K1's plan (``k1_plan``, ops/scan_variants.py
  ``k1_instance``) is K1's kernel, so each case times K1 among the
  neighbours of its design;
* forward cases only: ``V2``, the batch-major kernel (``selective_scan_
  batch_major``) on the same sequences laid out (ns b, L, d), and ``K1 +
  permutes``, K1 on one stream of those ns b sequences fed and drained by
  the copies a batch-major caller needs (u, dt, B and C in, y out): the
  card's form of the probe's v1 against v1t.

Each variant is held to its plain version on the same inputs (``ok``:
within the dtype's tolerance, :data:`TOL`) and reports its time, the
bound (:func:`~vit_cnn_tpu_torch.tools.bound`: the inputs and output
once over the HBM rate against one exp per state element and step over
the exp rate, as ``chip_smoke.py`` reckons K1's), its share of the bound,
max|diff| and the plain version's time. V1's instance at K1's plan must
also equal K1 bit for bit (``equal_to_k1``). Each row names the kernel it
launches
(``kernel``: the launch counter's key). One JSON line per case and dtype,
then one summary line; the exit code is 1 if any variant disagrees.
"""

from __future__ import annotations

import itertools
import json
import sys

import torch

from . import all_ok, bound, card_line, compare, median_ms, scan_inputs

STATE = 16
BAND = 7588          # windows of one flagship serving band (chunk 8192)
PROBE_B = 40960      # the probes' batch
# (label, streams, L, d, b, reverse): serving stage 1 and 2 at one band,
# forward over the layer's 6 streams and reverse over its 4; the probes'
# batch once per stage, one stream, forward
CASES = (("serving stage 1", 6, 81, 72, BAND, False),
         ("serving stage 1", 4, 81, 72, BAND, True),
         ("serving stage 2", 6, 49, 128, BAND, False),
         ("serving stage 2", 4, 49, 128, BAND, True),
         ("probe stage 1", 1, 81, 72, PROBE_B, False),
         ("probe stage 2", 1, 49, 128, PROBE_B, False))
DTYPES = (torch.bfloat16, torch.float32)


def _batch_major(x):
    """(ns, L, ch, b) -> (ns b, L, ch), a contiguous copy."""
    ns, L, ch, b = x.shape
    return x.permute(0, 3, 1, 2).contiguous().view(ns * b, L, ch)


def k1_through_permutes(u, dt, A, B, C, D):
    """K1 on batch-major inputs: permute copies to lane-major, K1 on one
    stream, y copied back to (b, L, d)."""
    from ..ops.selective_scan import selective_scan

    lane = lambda x: x.permute(1, 2, 0).contiguous()
    y = selective_scan(lane(u), lane(dt), A, lane(B), lane(C), D)
    return y.permute(2, 0, 1).contiguous()


def sweep(label, ns, L, d, b, reverse, dtype, reps=10,
          plain_reps=3) -> dict:
    """Every variant at one case and dtype; see the module's docstring."""
    from ..ops.scan_variants import (TILE_CHUNKS, TILE_ROWS, k1_instance,
                                     selective_scan_batch_major,
                                     selective_scan_batch_major_reference,
                                     selective_scan_tiled)
    from ..ops.selective_scan import selective_scan, selective_scan_reference

    dn = str(dtype).split(".")[1]
    g = torch.Generator(device="cuda").manual_seed(0)
    args = scan_inputs(g, ns, L, d, STATE, b, dtype)
    want = selective_scan_reference(*args, reverse=reverse)
    plain_ms = median_ms(lambda: selective_scan_reference(
        *args, reverse=reverse), plain_reps)
    bnd = bound(list(args) + [want], dn, exps=ns * L * d * STATE * b)
    variants = []

    def add(name, kernel, fn, ref, plain, **extra):
        got = fn()
        err, ok = compare(got, ref, dn)
        ms = median_ms(fn, reps)
        variants.append(dict(variant=name, kernel=kernel, ms=ms,
                             bound_ms=bnd[0], share=bnd[0] / ms,
                             max_abs_err=err, ok=ok, plain_ms=plain, **extra))
        return got

    k1 = add("K1", "selective_scan",
             lambda: selective_scan(*args, reverse=reverse), want, plain_ms)
    plan = k1_instance(ns, L, d, STATE, b, dtype)
    for rows, chunk in itertools.product(TILE_ROWS, TILE_CHUNKS):
        got = add("V1 rows={} chunk={}".format(rows, chunk),
                  "selective_scan_tiled",
                  lambda r=rows, c=chunk: selective_scan_tiled(
                      *args, reverse=reverse, rows=r, chunk=c),
                  want, plain_ms, rows=rows, chunk=chunk,
                  k1_plan=(rows, chunk) == plan)
        if (rows, chunk) == plan:            # K1's own instance
            same = torch.equal(got, k1)
            variants[-1].update(equal_to_k1=same)
            variants[-1]["ok"] &= same
        del got
    del k1
    if not reverse:
        u, dt, A, B, C, D = args
        bm = (_batch_major(u), _batch_major(dt), A, _batch_major(B),
              _batch_major(C), D)
        del args, u, dt, B, C
        want = _batch_major(want)
        plain_bm = median_ms(lambda: selective_scan_batch_major_reference(
            *bm), plain_reps)
        add("V2", "selective_scan_batch_major",
            lambda: selective_scan_batch_major(*bm), want, plain_bm)
        add("K1 + permutes", "selective_scan",
            lambda: k1_through_permutes(*bm), want, plain_bm)
    return dict(case=label, streams=ns, L=L, d=d, b=b, n=STATE,
                reverse=reverse, dtype=dn, bound_ms=bnd[0], bound_by=bnd[1],
                plain_ms=plain_ms, variants=variants)


def summary(results) -> dict:
    """Per case and dtype: K1's time, V1's instance at K1's plan, the
    fastest V1 instance and it over K1, and V2 against K1 + permutes."""
    out = []
    for r in results:
        ms = {v["variant"]: v["ms"] for v in r["variants"]}
        v1s = [v for v in r["variants"] if v["variant"].startswith("V1")]
        v1 = min(v1s, key=lambda v: v["ms"])
        plan = next(v for v in v1s if v["k1_plan"])
        out.append(dict(case=r["case"], streams=r["streams"],
                        reverse=r["reverse"], dtype=r["dtype"], k1_ms=ms["K1"],
                        k1_plan=[plan["rows"], plan["chunk"]],
                        k1_plan_ms=plan["ms"],
                        best_v1=[v1["rows"], v1["chunk"]], best_v1_ms=v1["ms"],
                        best_v1_over_k1=v1["ms"] / ms["K1"],
                        v2_ms=ms.get("V2"),
                        k1_permutes_ms=ms.get("K1 + permutes"),
                        bound_ms=r["bound_ms"]))
    return {"summary": out, "ok": all(all_ok(r) for r in results)}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("scan_sweep: CUDA is not available")
    print(card_line(), flush=True)
    results = []
    for case in CASES:
        for dtype in DTYPES:
            results.append(sweep(*case, dtype))
            print(json.dumps(results[-1]), flush=True)
            torch.cuda.empty_cache()
    last = summary(results)
    print(json.dumps(last), flush=True)
    return 0 if last["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
