"""Frozen operation counts of FusAtNet at patch 11, 144 + 1 bands, 16
outputs, and the functions that make them.

``torch.utils.flop_counter.FlopCounterMode`` over the reference
(``reference/fusatnet-h13.py``) counts matmuls and convolutions, two
FLOPs a multiply-add; elementwise work (BatchNorm, ReLU, pools) is not
counted. The counts do not depend on the weights' values, only on the
state_dict's shapes, which :func:`recount` takes.
"""

from __future__ import annotations

from typing import Dict

import torch

#: forward FLOPs a window (eval), all products; of them, the convolutions
FLOPS_PER_WINDOW = 6915912704
CONV_FLOPS_PER_WINDOW = 6915879936
#: forward + backward FLOPs a patch of a train step; of them, the
#: convolutions (forward, and both adjoints but the input's of the first)
TRAIN_FLOPS_PER_PATCH = 20586879744
CONV_TRAIN_FLOPS_PER_PATCH = 20586781440


def _counted(fn) -> Dict[str, float]:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    ops = counter.get_flop_counts().get("Global", {})
    conv = sum(v for k, v in ops.items() if "convolution" in str(k))
    return {"all": float(counter.get_total_flops()), "conv": float(conv)}


def recount(reference, shapes: Dict[str, tuple], batch: int = 2,
            patch: int = 11, bands=(144, 1)) -> Dict[str, float]:
    """The four counts, per window or patch, from ``batch`` windows through
    ``reference`` on zero weights of ``shapes``."""
    sd = {k: torch.zeros(s) for k, s in shapes.items()}
    for k in sd:
        if k.endswith("running_var"):
            sd[k] += 1.0
    x1 = torch.zeros((batch, patch, patch, bands[0]))
    x2 = torch.zeros((batch, patch, patch, bands[1]))
    fwd = _counted(lambda: reference.forward(sd, x1, x2))
    params = {k: v.requires_grad_() if not k.endswith(("running_mean",
                                                       "running_var"))
              else v for k, v in sd.items()}

    def step():
        out, _ = reference.train_forward(params, x1, x2)
        out.sum().backward()

    train = _counted(step)
    return {"FLOPS_PER_WINDOW": fwd["all"] / batch,
            "CONV_FLOPS_PER_WINDOW": fwd["conv"] / batch,
            "TRAIN_FLOPS_PER_PATCH": train["all"] / batch,
            "CONV_TRAIN_FLOPS_PER_PATCH": train["conv"] / batch}
