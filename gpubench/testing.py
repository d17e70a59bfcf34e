"""Cells at a size the CPU holds, for the harness's tests: the cell's own
configuration and traffic with a 24 x 64 scene of 8 HSI bands, three
labelled and two training pixels a class, batches of 8 and bands of two
origin rows. Widths, depths and the patch stay the configuration's."""

from __future__ import annotations

import copy
import io
from typing import Dict

from . import layout


def small(name: str, **traffic) -> Dict:
    info = copy.deepcopy(layout.cell(name))
    info["config"]["scene"].update(
        height=24, width=64, hsi_bands=8, labelled_per_class=[3] * 15,
        train_per_class=[2] * 15)
    sizes = dict(batch_size=8, trace_epochs=1, trace_requests=1, chunk=128,
                 reference_block=64)
    info["traffic"].update({k: v for k, v in sizes.items()
                            if k in info["traffic"]})
    info["traffic"].update(traffic)
    return info


def run_small(name: str, seed: int = 7, trace: bool = False, fault=None,
              **traffic):
    """(result, standard output, standard error) of one small CPU run."""
    import torch

    from .run import run

    torch.set_num_threads(2)
    out, err = io.StringIO(), io.StringIO()
    result = run(name, seed, 0.2, trace, device="cpu", fault=fault,
                 info=small(name, **traffic), out=out, err=err)
    return result, out.getvalue(), err.getvalue()
