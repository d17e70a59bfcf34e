"""MoCo contrastive pretraining: the encoder, the momentum state and one
forward.

Port of :mod:`vit_cnn_tpu.models.moco` (the reference's
``moco_based_NNCNet`` contract, ``net(x1_v1, x1_v2, x2_v1, x2_v2) ->
(logits, target, k)``; ref: model_utils.py:473-487, :748-750).

* :class:`DualModalEncoder` — two conv trunks (3x3 SAME convs without
  bias, BatchNorm, ReLU; 64 -> 128 channels on the HSI, 16 -> 32 on the
  LiDAR), spatial means, concatenated, and a two-layer projection, under
  flax's auto names (``Conv_0`` ... ``Dense_1``) so
  :mod:`..convert` maps the flax variables onto it.
* :class:`MoCoState` — the key encoder's variables (a momentum copy of
  every entry of the encoder's state_dict, BatchNorm statistics
  included), the (K, D) queue of negatives and its write pointer.
* :func:`moco_forward` — one forward of the pair.

Both encoder forwards normalise with the batch's statistics, and the JAX
package discards the statistics they would update (``mutable=
["batch_stats"]``, result dropped), so no running statistic ever changes
in pretraining: the encoder's norms are :class:`BatchStatsNorm`, which
never writes them, and a saved encoder holds its initial statistics.
flax's BatchNorm default momentum there is 0.99, not the 0.9 of
:class:`..nn.layers.ChannelLastBatchNorm`; the momentum only weighs the
running update, which never happens, so it changes no output. The eps is
1e-5 on both sides.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.layers import ChannelLastBatchNorm, Conv, Dense
from ..parallel.mesh import gather_rows


class BatchStatsNorm(ChannelLastBatchNorm):
    """flax ``nn.BatchNorm`` applied with its statistics collection
    mutable and the update thrown away: a train-mode batch is normalised
    with its own statistics, the running ones stay as they are."""

    updates_statistics = False


class DualModalEncoder(nn.Module):
    """(hsi (B, P, P, C1), lidar (B, P, P, C2)) -> (B, embed_dim)."""

    def __init__(self, in_channels1: int, in_channels2: int,
                 embed_dim: int = 128):
        super().__init__()
        widths = [(in_channels1, 64), (64, 128),     # the HSI trunk
                  (in_channels2, 16), (16, 32)]      # the LiDAR trunk
        for i, (cin, cout) in enumerate(widths):
            self.add_module("Conv_{}".format(i), Conv(
                cin, cout, (3, 3), padding=1, use_bias=False))
            self.add_module("BatchNorm_{}".format(i), BatchStatsNorm(cout))
        self.Dense_0 = Dense(128 + 32, embed_dim)
        self.Dense_1 = Dense(embed_dim, embed_dim)

    def _trunk(self, x, first: int):
        for i in (first, first + 1):
            x = getattr(self, "Conv_{}".format(i))(x)
            x = F.relu(getattr(self, "BatchNorm_{}".format(i))(x))
        return x.mean(dim=(1, 2))

    def forward(self, x1, x2):
        h = torch.cat([self._trunk(x1, 0), self._trunk(x2, 2)], dim=-1)
        return self.Dense_1(F.relu(self.Dense_0(h)))


@dataclasses.dataclass
class MoCoState:
    key_variables: Dict[str, torch.Tensor]   # momentum copy, state_dict keys
    queue: torch.Tensor                      # (K, D) L2-normalised negatives
    queue_ptr: int


def init_moco_state(encoder: nn.Module, queue_size: int, embed_dim: int,
                    generator: torch.Generator) -> MoCoState:
    """The key variables as a copy of the encoder's, and a queue of
    normal rows drawn from ``generator`` (on its device), each scaled to
    unit norm. The JAX package draws its queue from PRNGKey(0); a test
    that needs its queue carries it over (:mod:`..convert`)."""
    queue = torch.randn((queue_size, embed_dim), generator=generator,
                        device=generator.device)
    queue = queue / torch.linalg.vector_norm(queue, dim=1, keepdim=True)
    return MoCoState({k: v.detach().clone()
                      for k, v in encoder.state_dict().items()}, queue, 0)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=1, keepdim=True) + 1e-12)


def moco_forward(encoder: nn.Module, moco: MoCoState, x1_v1, x1_v2, x2_v1,
                 x2_v2, momentum: float = 0.999, temperature: float = 0.07
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            MoCoState]:
    """(logits, target, k, new state) of one MoCo forward; ``encoder`` in
    train mode. The query is view 1 through the online encoder; the key
    variables move first, ``momentum * key + (1 - momentum) * online``
    over every entry, and the key is view 2 through them, without
    gradient. The logits are ``[l_pos, l_neg] / temperature`` with
    target 0, and every row of ``k`` (the padded rows of a last batch
    too) goes into the queue at the pointer: under an engaged mesh
    (:mod:`..parallel.mesh`) every rank's keys, in batch order, and the
    returned ``k`` is the global batch's."""
    q = _unit(encoder(x1_v1, x2_v1))
    with torch.no_grad():
        online = encoder.state_dict()
        key_vars = {name: momentum * v + (1.0 - momentum) * online[name]
                    for name, v in moco.key_variables.items()}
        k = _unit(torch.func.functional_call(encoder, key_vars,
                                             (x1_v2, x2_v2)))
    l_pos = (q * k).sum(dim=1, keepdim=True)
    l_neg = q @ moco.queue.T
    logits = torch.cat([l_pos, l_neg], dim=1) / temperature
    target = torch.zeros(q.shape[0], dtype=torch.long, device=q.device)

    # dynamic_update_slice: the start clamps so that the rows fit; under
    # an engaged mesh the global batch's keys, in batch order
    k = gather_rows(k)
    size, b = moco.queue.shape[0], k.shape[0]
    start = min(moco.queue_ptr, size - b)
    queue = torch.cat([moco.queue[:start], k, moco.queue[start + b:]])
    new = MoCoState(key_vars, queue, (moco.queue_ptr + b) % size)
    return logits, target, k, new
