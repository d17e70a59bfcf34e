"""Sweep of head-last attention's variants on the card.

  python -m vit_cnn_tpu_torch.tools.heads_attn_variants

The card's form of the JAX package's probes ``perf/mhst_attn_variants.py``
and ``perf/mhst_attn_vpu.py``, which tried the formulations of the zoo's
head-last attention without the residual. At each shape (:data:`SHAPES`:
the probes' (4,096, 65, 16 heads of 4), MHST's pooled band, and the ViT
bands at 4 heads of 16 over 65 and 146 tokens), in bf16 and float32, it
times with CUDA-event medians:

* ``K8``: the zoo's kernel (ops/attention.py ``fused_attention_heads``),
  residual off;
* ``V3 per-head`` and ``V3 masked``: the tensor-core kernel
  (ops/heads_variants.py ``heads_attention_mma``), per-head dots (the
  probes' F) or full-width dots against head-masked K and V (G);
  bf16 only, and masked only where h * hd is a multiple of 16 up to 128;
* ``V4``: the CUDA-core kernel (``heads_attention_outer``), scores as hd
  rank-1 updates (H; C and E; and A and B, whose float32 dots and float32
  P are its arithmetic): one block a batch row, K and V staged as
  float32 by 16-byte loads.

Each is held to the plain version (``attention_reference_heads``,
residual off) on the same inputs (``ok``: within the dtype's tolerance,
:data:`TOL`; V3 rounds P to bf16 before P.V, as the probes' F and G do,
which bf16's tolerance covers) and names the kernel it launches
(``kernel``), and reports its time, the bound (the
inputs and output once over the HBM rate against n^2 exps per head and
row over the exp rate and 4 n^2 hd FLOPs over the type's peak, as
``chip_smoke.py`` reckons K8's), its share of the bound, max|diff|, the
plain version's time and, as the library's yardstick,
``scaled_dot_product_attention``'s time on the same inputs (timed here,
called nowhere in the port). One JSON line per shape and dtype, then one
summary line; the exit code is 1 if any variant disagrees.
"""

from __future__ import annotations

import json
import sys

import torch
import torch.nn.functional as F

from . import all_ok, bound, card_line, compare, median_ms

# (label, B, n, h, hd)
SHAPES = (("probe", 4096, 65, 16, 4),
          ("MHST pooled band", 7592, 65, 16, 4),
          ("ViT band n=65", 7592, 65, 4, 16),
          ("SpectralFormer band", 7620, 146, 4, 16))
DTYPES = (torch.bfloat16, torch.float32)


def sweep(label, B, n, h, hd, dtype, reps=10, plain_reps=3) -> dict:
    """Every variant at one shape and dtype; see the module's docstring."""
    from ..ops.attention import (attention_reference_heads,
                                 fused_attention_heads)
    from ..ops.heads_variants import (MASKED_MAX_C, heads_attention_mma,
                                      heads_attention_outer)

    dn = str(dtype).split(".")[1]
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((B, n, h, hd), generator=g, device="cuda")
               .to(dtype) for _ in range(3))
    scale = hd ** -0.5
    want = attention_reference_heads(q, k, v, scale)
    plain_ms = median_ms(lambda: attention_reference_heads(q, k, v, scale),
                         plain_reps)
    bnd = bound([q, k, v, want], dn, exps=B * h * n * n,
                flops=4 * B * h * n * n * hd)
    heads_first = lambda t: t.transpose(1, 2)
    library_ms = median_ms(lambda: F.scaled_dot_product_attention(
        heads_first(q), heads_first(k), heads_first(v), scale=scale), reps)
    variants = []

    def add(name, kernel, fn):
        got = fn()
        err, ok = compare(got, want, dn)
        ms = median_ms(fn, reps)
        variants.append(dict(variant=name, kernel=kernel, ms=ms,
                             bound_ms=bnd[0], share=bnd[0] / ms,
                             max_abs_err=err, ok=ok, plain_ms=plain_ms,
                             library_ms=library_ms))

    add("K8", "fused_attention_heads",
        lambda: fused_attention_heads(q, k, v, scale))
    if dtype == torch.bfloat16:
        add("V3 per-head", "heads_attention_mma",
            lambda: heads_attention_mma(q, k, v, scale))
        if (h * hd) % 16 == 0 and h * hd <= MASKED_MAX_C:
            add("V3 masked", "heads_attention_mma",
                lambda: heads_attention_mma(q, k, v, scale, masked=True))
    add("V4", "heads_attention_outer",
        lambda: heads_attention_outer(q, k, v, scale))
    return dict(shape=label, B=B, n=n, h=h, hd=hd, dtype=dn,
                bound_ms=bnd[0], bound_by=bnd[1], plain_ms=plain_ms,
                library_ms=library_ms, variants=variants)


def summary(results) -> dict:
    """Per shape and dtype: every variant's ms, the bound and SDPA's ms."""
    out = [dict(shape=r["shape"], dtype=r["dtype"], bound_ms=r["bound_ms"],
                library_ms=r["library_ms"],
                ms={v["variant"]: v["ms"] for v in r["variants"]})
           for r in results]
    return {"summary": out, "ok": all(all_ok(r) for r in results)}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("heads_attn_variants: CUDA is not available")
    print(card_line(), flush=True)
    results = []
    for shape in SHAPES:
        for dtype in DTYPES:
            results.append(sweep(*shape, dtype))
            print(json.dumps(results[-1]), flush=True)
    last = summary(results)
    print(json.dumps(last), flush=True)
    return 0 if last["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
