"""Profile steady train steps on the card, by op family.

  python -m vit_cnn_tpu_torch.tools.profile_train [--model MODEL]

The flagship by default, or any registered model (the transformer and
CNN zoos; HCTnet on the PCA of the HSI) with its seeded weights; bf16 over
float32 master weights, batch 1024, flip/rotate on, one fixed batch, as
``chip_smoke.py``'s steady steps. After 3 warm-up steps it
times 5 steps on the host clock without the profiler, then 5 steps under
``torch.profiler``, and prints one JSON line:

* ``host_ms_per_step``: the unprofiled steps (host clock, synchronized);
* ``profiled_host_ms_per_step``: the profiled steps on the host clock
  (the profiler slows the host, so this is longer);
* ``device_ms_per_step``: kernel time of the profiled steps (the sum of
  the CUDA rows of ``key_averages()``);
* ``busy``: device ms over profiled host ms, both of the same steps (a
  lower bound, since the profiler's host cost adds idle time), and
  ``busy_unprofiled``: device ms over the unprofiled steps' host ms (the
  steps just before, in the same process);
* ``families``: [family, device ms per step, share, launches per step];
* ``plain_backward``: per profiler range around the plain backward of K8
  and K9 (``ops/attention.py``), its device ms per step and share of the
  step's device time: the range's CPU row's device total, which sums the
  kernels launched inside the range, as ``device_ms_per_step`` sums
  kernels (the range's GPU row spans its first kernel to its last, idle
  gaps included, and is not used); these kernels also sit in their
  families.

Then the 25 kernels with the most device time. Run it where a card is.
"""

from __future__ import annotations

import argparse
import collections
import json
import time

import torch

from ..ops.attention import HEADS_BACKWARD, POOLED_BACKWARD
from . import card_line, load_scene, model_state, train_step

BATCH, WARM, STEPS = 1024, 3, 5

# (substring of the kernel name, family), tried in order
_FAMILIES = (
    ("selective_scan_bwd", "K5 scan backward"),
    ("selective_scan_fwd_kernel", "K1 scan forward"),
    ("selective_scan_kernel", "K1 scan forward"),
    ("dir_conv_silu_bwd", "K6 dir_conv backward"),
    ("dir_conv_silu_kernel", "K2 dir_conv forward"),
    ("inv_perm_weighted_sum_bwd", "K7 inv-sum backward"),
    ("inv_perm_weighted_sum_kernel", "K3 inv-sum forward"),
    ("sum_partials", "K5-K7 partial sums"),
    ("sum_quads", "K5-K7 partial sums"),
    ("heads_kernel", "K8 heads attention"),
    ("pooled_kernel", "K9 pooled attention"),
    ("attention", "K4 attention forward"),
)
_PLAIN = (
    # cuDNN's convolutions run as implicit GEMMs: match them first
    (("conv", "cudnn", "implicit", "winograd", "fprop"), "conv"),
    (("gemm", "nvjet", "cutlass", "xmma", "sm90_", "cublas"), "GEMM"),
    (("multi_tensor", "adam"), "optimizer"),
    (("index", "gather", "scatter"), "index/gather/scatter"),
    (("reduce", "norm", "softmax"), "reductions/softmax"),
    (("memcpy", "memset"), "memcpy/memset"),
    (("copy", "cat", "elementwise", "vectorized", "unrolled"),
     "elementwise/copy/cast"),
)


def family(kernel: str) -> str:
    name = kernel.lower()
    for key, fam in _FAMILIES:
        if key in name:
            return fam
    for keys, fam in _PLAIN:
        if any(k in name for k in keys):
            return fam
    return "other"


def _device_us(event) -> float:
    t = getattr(event, "self_device_time_total", None)
    return event.self_cuda_time_total if t is None else t


def kernel_rows(rows):
    """The kernel rows of a profile's ``key_averages()`` ``rows``: CUDA
    rows that are neither user annotations nor the plain-backward ranges
    (a range's GPU row spans its kernels, so it is kept out of the
    kernel sums)."""
    return [e for e in rows if str(e.device_type).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False)
            and e.key not in (HEADS_BACKWARD, POOLED_BACKWARD)]


def _timed_steps(trainer, args, n: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        trainer._step(*args)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", default="Multimodality_Mamba")
    model = parser.parse_args(argv).model
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from torch.profiler import ProfilerActivity, profile

    print(card_line(), flush=True)
    scene = load_scene()
    trainer, step_args = train_step(scene, model_state(scene, model), "cuda",
                                    BATCH, model=model, bf16=True, flip=True)
    _timed_steps(trainer, step_args, WARM)
    host_ms = _timed_steps(trainer, step_args, STEPS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_ms = _timed_steps(trainer, step_args, STEPS)

    rows = prof.key_averages()
    kernels = kernel_rows(rows)
    plain_bwd = {}
    for name in (HEADS_BACKWARD, POOLED_BACKWARD):
        cpu = [e.device_time_total for e in rows if e.key == name
               and not str(e.device_type).endswith("CUDA")]
        if cpu:
            plain_bwd[name] = sum(cpu) / 1e3 / STEPS
    ms = collections.Counter()
    launches = collections.Counter()
    for e in kernels:
        ms[family(e.key)] += _device_us(e) / 1e3 / STEPS
        launches[family(e.key)] += e.count / STEPS
    device_ms = sum(ms.values())
    print(json.dumps({
        "model": model, "batch": BATCH, "steps": STEPS,
        "host_ms_per_step": host_ms,
        "profiled_host_ms_per_step": profiled_ms,
        "device_ms_per_step": device_ms,
        "busy": device_ms / profiled_ms,
        "busy_unprofiled": device_ms / host_ms,
        "families": [(f, t, t / device_ms, launches[f])
                     for f, t in ms.most_common()],
        "plain_backward": {k: (t, t / device_ms)
                           for k, t in plain_bwd.items()}}), flush=True)
    for e in sorted(kernels, key=_device_us, reverse=True)[:25]:
        print("{:9.3f} ms/step {:6.1f} launches  {}".format(
            _device_us(e) / 1e3 / STEPS, e.count / STEPS,
            e.key[:110]), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
