"""Frozen counts of Multimodality_Mamba at patch 9, 144 + 1 bands, 16
outputs, and the functions that make them.

* ``FLOPS_PER_WINDOW``: ``torch.utils.flop_counter.FlopCounterMode`` over
  the reference's forward (``reference/mamba-h13.py``), two FLOPs a
  multiply-add of the matmuls, 1 x 1 and 3 x 3 convs, TokenLearner and
  NonLocal products; the scan's recurrence, norms and gates are not
  counted. It depends on the state_dict's shapes only (:func:`recount`).
* K1's least time (:func:`k1_least_seconds`): each of a band's four K1
  launches (stage 1 (L 81, d 72) and stage 2 (L 49, d 128), the six
  forward and four reverse streams of '{L}_2+8', state n 16) reads u, dt,
  B, C in bf16 and A, D in float32 once and writes y once, and takes one
  exp a (stream, step, channel, state, window); its least time is the
  larger of bytes over the HBM rate and exps over the SFU rate
  (:func:`gpubench.peaks.least_seconds`).
"""

from __future__ import annotations

from typing import Dict

import torch

from gpubench.peaks import BYTES, least_seconds

#: forward FLOPs a window
FLOPS_PER_WINDOW = 161195632
#: (L, d) of the two Mamba stages; streams scanned forward and in reverse
STAGES = ((81, 72), (49, 128))
STREAMS = (6, 4)
STATE = 16
#: the windows of a band at chunk 8192 on the 1905-pixel-wide scene
BAND_WINDOWS = 7588
#: K1's least seconds for one band of BAND_WINDOWS windows
K1_LEAST_S_PER_BAND = 0.0034988629333333335


def k1_least_seconds(b: int, dtype: str = "bfloat16") -> float:
    """K1's least seconds over the four launches of one band of ``b``
    windows."""
    e = BYTES[dtype]
    total = 0.0
    for L, d in STAGES:
        for ns in STREAMS:
            nbytes = (3 * ns * L * d * b + 2 * ns * L * STATE * b) * e \
                + (d * STATE + d) * 4
            total += least_seconds(nbytes, exps=ns * L * d * STATE * b)
    return total


def recount(reference, shapes: Dict[str, tuple], batch: int = 2,
            patch: int = 9, bands=(144, 1)) -> Dict[str, float]:
    """``FLOPS_PER_WINDOW`` from ``batch`` windows through ``reference``
    on zero weights of ``shapes``, and the K1 bound of a band."""
    from torch.utils.flop_counter import FlopCounterMode

    sd = {k: torch.zeros(s) for k, s in shapes.items()}
    for k in sd:
        if k.endswith("running_var"):
            sd[k] += 1.0
    x1 = torch.zeros((batch, patch, patch, bands[0]))
    x2 = torch.zeros((batch, patch, patch, bands[1]))
    with FlopCounterMode(display=False) as counter:
        reference.forward(sd, x1, x2)
    return {"FLOPS_PER_WINDOW": counter.get_total_flops() / batch,
            "K1_LEAST_S_PER_BAND": k1_least_seconds(BAND_WINDOWS)}
