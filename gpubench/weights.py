"""Seeded weights, drawn on the device, for every model of the port's
registry.

The scale rules are those of ``vit_cnn_tpu_torch/convert.py``
``seeded_variables`` (which draws on the host through flax trees),
restated for PyTorch's state_dict names and layouts: a weight of
dimension 2 or more (conv (out, in, *k), dense (out, in)) is normal over
the square root of its fan-in, the Mamba conv's taps (k, d) over the
square root of k; norm scales 1 + 0.2 N; biases 0.1 N; running means 0.1
N, running variances 1 + 0.3 U; Mamba's dt bias the inverse softplus of a
log-uniform step in [1e-3, 1e-1], ``A_log`` log(1..n) + 0.1 N, ``D`` 1 +
0.1 N, the direction gate 0.5 N, the position embedding 0.02 N.

The transformer zoo's and MFT's, HCTnet's and S2ENet's bare parameters
keep flax's shape in the state_dict, so their rules read the same axes:
learned tokens and positions (``_TOKEN_LEAVES``) 0.5 N; matrices
contracted over their last axis (``_MIXING_LEAVES``, S2EFT's
``skipcat<i>``) N over the square root of that axis; MHST's and GLT_Net's
mixing scalars (``_SCALAR_LEAVES``) 0.5 + 0.1 N; ``skipcat<i>_bias``
0.1 N. A leaf is matched on its key's last component, as
``seeded_variables`` matches on the flax leaf.

One normal and one uniform draw over all leaves, in state_dict order, in
float32 (the master weights the program serves and trains from).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

#: learned tokens and positions of the transformer zoo, MFT and HCTnet
_TOKEN_LEAVES = ("cls_token", "pos_embedding", "encoder_pos_embed",
                 "decoder_pos_embed", "position_embeddings")
#: matrices contracted over their last axis: MFT's and HCTnet's token
#: pooling, S2ENet's affinity reductions
_MIXING_LEAVES = ("token_wA", "token_wV", "token_wA_L", "token_wV_L",
                  "dim_reduce")
#: learned mixing scalars of MHST and GLT_Net (shape (1,))
_SCALAR_LEAVES = ("weight_hsi", "weight_lidar", "vit_cls_coefficient",
                  "cnn_cls_coefficient", "xishu1", "xishu2", "coefficient1",
                  "coefficient2")


def _leaf(key: str, shape, z: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    last = key.rsplit(".", 1)[-1]
    if last == "running_mean":
        return 0.1 * z
    if last == "running_var":
        return 1.0 + 0.3 * u
    if last == "A_log":
        n = shape[1]
        base = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                      device=z.device))
        return base[None] + 0.1 * z
    if last == "D":
        return 1.0 + 0.1 * z
    if last == "direction_gate":
        return 0.5 * z
    if last == "pos_embed":
        return 0.02 * z
    if key.endswith("dt_proj.bias"):
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        return dt + torch.log(-torch.expm1(-dt))
    if key.endswith("conv1d.weight"):
        return z / math.sqrt(shape[0])
    if last == "bias":
        return 0.1 * z
    if last == "weight" and len(shape) == 1:
        return 1.0 + 0.2 * z
    if last == "weight":
        return z / math.sqrt(math.prod(shape[1:]))
    if last in _TOKEN_LEAVES:
        return 0.5 * z
    if last in _MIXING_LEAVES:
        return z / math.sqrt(shape[-1])
    if last in _SCALAR_LEAVES:
        return 0.5 + 0.1 * z
    if last.startswith("skipcat") and last.endswith("_bias"):
        return 0.1 * z
    if last.startswith("skipcat"):
        return z / math.sqrt(shape[-1])
    raise KeyError("{}: no seeded rule".format(key))


def seeded_state(shapes: Dict[str, tuple], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """A float32 state_dict on ``device`` for ``shapes`` (name -> shape,
    in state_dict order), drawn from ``seed``."""
    total = sum(math.prod(s) for s in shapes.values())
    g = torch.Generator(device=device).manual_seed(int(seed))
    z_all = torch.randn(total, generator=g, device=device)
    u_all = torch.rand(total, generator=g, device=device)
    out, off = {}, 0
    for key, shape in shapes.items():
        n = math.prod(shape)
        z = z_all[off:off + n].view(shape)
        u = u_all[off:off + n].view(shape)
        out[key] = _leaf(key, tuple(shape), z, u).contiguous()
        off += n
    return out
