"""The device trace of a traced span, reduced to what the per-layer
metrics read.

``torch.profiler`` (CPU and CUDA activities) records the span; its raw
kineto events give each device operation (kernel, memcpy, memset) and
each host operation with its start and length on one clock. From them:

* ``busy_s``: the union of the device operations' intervals within the
  span, and ``window_s``, the span's length less the device's idle time
  while the host was in one of the profiler's own operations
  (:data:`PROFILER_OPS`): that idle time is the tracer's, not the
  program's;
* per family, the device seconds of the kernels of that family, by the
  classifier copied from ``vit_cnn_tpu_torch/tools/profile_train.py``
  (``family``), with the port's kernel names spelled out in full so that
  a library kernel whose name merely contains a word such as
  "attention" does not count as one of them;
* ``breakdown``: the device operations that took most time and the
  longest idle gaps, each gap labelled by the innermost host operation
  running at its middle.
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Tuple

#: (substring of the kernel name, family), tried in order: the port's
#: hand-written kernels (csrc/*.cu) by their own names
KERNELS = (
    ("selective_scan_bwd", "K5 scan backward"),
    ("selective_scan_fwd_kernel", "K1 scan forward"),
    ("dir_conv_silu_bwd", "K6 dir_conv backward"),
    ("dir_conv_silu_kernel", "K2 dir_conv forward"),
    ("inv_perm_weighted_sum_bwd", "K7 inv-sum backward"),
    ("inv_perm_weighted_sum_kernel", "K3 inv-sum forward"),
    ("sum_partials", "K5-K7 partial sums"),
    ("sum_quads", "K5-K7 partial sums"),
    ("heads_kernel", "K8 heads attention"),
    ("pooled_kernel", "K9 pooled attention"),
    ("attention_tile_kernel", "K4 attention forward"),
    ("attention_kernel", "K4 attention forward"),
)
#: the families of library kernels, by words of their names
LIBRARY = (
    # cuDNN's convolutions run as implicit GEMMs: match them first
    (("conv", "cudnn", "implicit", "winograd", "fprop", "dgrad", "wgrad"),
     "conv"),
    (("gemm", "nvjet", "cutlass", "xmma", "sm90_", "cublas"), "GEMM"),
    (("multi_tensor", "adam"), "optimizer"),
    (("index", "gather", "scatter"), "index/gather/scatter"),
    (("reduce", "norm", "softmax"), "reductions/softmax"),
    (("memcpy", "memset"), "memcpy/memset"),
    (("copy", "cat", "elementwise", "vectorized", "unrolled"),
     "elementwise/copy/cast"),
)


#: host operations of the profiler itself (CUPTI asking for a new
#: activity buffer), during which the host launches nothing
PROFILER_OPS = ("Activity Buffer Request",)


def family(kernel: str) -> str:
    name = kernel.lower()
    for key, fam in KERNELS:
        if key in name:
            return fam
    for keys, fam in LIBRARY:
        if any(k in name for k in keys):
            return fam
    return "other"


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _overlap(xs: List[Tuple[int, int]], ys: List[Tuple[int, int]]) -> int:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


class Trace:
    """A traced span ``[t0_ns, t1_ns]`` (host clock of the profiler) and
    its device and host operations, ``(name, start_ns, end_ns)``."""

    def __init__(self, device_ops, host_ops, t0_ns: int, t1_ns: int):
        self.t0, self.t1 = t0_ns, t1_ns
        clip = lambda a, b: (max(a, t0_ns), min(b, t1_ns))
        self.device_ops = [(n,) + clip(a, b) for n, a, b in device_ops
                           if b > t0_ns and a < t1_ns]
        self.host_ops = host_ops
        self.busy = _union([(a, b) for _, a, b in self.device_ops if b > a])
        stalls = _union([clip(a, b) for n, a, b in host_ops
                         if n in PROFILER_OPS and b > t0_ns and a < t1_ns])
        self.profiler_idle_ns = _overlap(self.gaps(), stalls)
        self._families = None

    @classmethod
    def from_profiler(cls, prof, span: str) -> "Trace":
        """From a stopped ``torch.profiler.profile``: its raw events,
        device operations being the CUDA events that are no user
        annotation; the traced span runs from the first host range named
        ``span`` to the end of the last."""
        device, host = [], []
        for e in prof.profiler.kineto_results.events():
            a = e.start_ns()
            b = a + e.duration_ns()
            if str(e.device_type()).endswith("CUDA"):
                if not e.is_user_annotation():
                    device.append((e.name(), a, b))
            else:
                host.append((e.name(), a, b))
        spans = [(a, b) for name, a, b in host if name == span]
        return cls(device, host, min(a for a, _ in spans),
                   max(b for _, b in spans))

    @property
    def window_s(self) -> float:
        """The span less the device's idle time in profiler operations."""
        return (self.t1 - self.t0 - self.profiler_idle_ns) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e9

    def family_seconds(self) -> Dict[str, float]:
        if self._families is None:
            out: Dict[str, float] = collections.Counter()
            for name, a, b in self.device_ops:
                out[family(name)] += (b - a) / 1e9
            self._families = dict(out)
        return self._families

    def top_ops(self, n: int = 10) -> List[list]:
        by_name: Dict[str, float] = collections.Counter()
        for name, a, b in self.device_ops:
            by_name[name] += (b - a) / 1e9
        # kernel names are C++ signatures: the first 160 characters name them
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[k[:160], v] for k, v in ranked]

    def gaps(self) -> List[Tuple[int, int]]:
        """The idle intervals of the device within the span."""
        out, t = [], self.t0
        for a, b in self.busy:
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            out.append((t, self.t1))
        return out

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The ``n`` longest idle gaps, each named by the innermost host
        operation running at its middle (the latest-starting one that
        covers it), "none" where none does."""
        gaps = sorted(self.gaps(), key=lambda ab: ab[0] - ab[1])[:n]
        ops = sorted(self.host_ops, key=lambda op: op[1])
        starts = [op[1] for op in ops]
        out = []
        for a, b in gaps:
            mid = (a + b) // 2
            label = "none"
            for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                if ops[i][2] >= mid:
                    label = ops[i][0]
                    break
                if mid - ops[i][1] > 120e9:
                    break
            out.append([label, (b - a) / 1e9])
        return out
