"""MoCo contrastive pretraining loop.

Port of :mod:`vit_cnn_tpu.train.pretrain` (ref: model_utils.py:682-851).
One step: the two views of a batch (pipeline/twoview.py), the MoCo
forward (models/moco.py), the InfoNCE loss (cross-entropy of the logits
against target 0, the padded tail of an epoch masked by ``valid``), the
backward and an Adam step (optax.adam's b1 0.9, b2 0.999, eps 1e-8) at
the epoch's learning rate. The epoch loss sums on the device and the
host reads it once an epoch. Pretraining runs in float32, as the JAX
package's does.

The learning rate follows :func:`adjust_learning_rate` (ref:
utils.py:21-30), evaluated at ``e - 1`` for epoch ``e`` (ref:
model_utils.py:736). Checkpoints (ref: model_utils.py:822-851): the best
epoch-mean loss, compared as ``abs(avg) <= best`` from 100.0, under
``pre_train/best_epoch``, and fixed snapshots at epochs 128, 200 and 300
under ``pre_train/final_epoch``, in the JAX package's file format and
names (train/checkpoint.py).

With ``mesh`` (:mod:`..parallel.mesh`; the Python API only, as in JAX:
``--pretrain`` takes no mesh) the step is data parallel as the Trainer's:
each rank's rows of the global batch, the views' draws and BatchNorm's
statistics the global batch's, the global keys into the replicated queue,
the loss's denominator global and the gradients summed. Only rank 0
writes files and prints.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..convert import state_dict_to_flax
from ..models.moco import init_moco_state, moco_forward
from ..parallel import mesh as mesh_lib
from ..pipeline.twoview import TwoViewPipeline
from . import checkpoint as ckpt
from .loop import _host_state, _pad_to_multiple

SNAPSHOT_EPOCHS = (128, 200, 300)


def adjust_learning_rate(base_lr: float, epoch: int, hp: Dict) -> float:
    """The learning rate of (0-based) ``epoch``: cosine over
    ``hp["epoch"]`` epochs with ``hp["cos"]``, else 0.1x at each of
    ``hp["schedule_milestones"]`` reached."""
    lr = base_lr
    if hp.get("cos"):
        lr *= 0.5 * (1.0 + math.cos(math.pi * epoch / hp["epoch"]))
    else:
        for milestone in hp.get("schedule_milestones", []):
            lr *= 0.1 if epoch >= milestone else 1.0
    return lr


class Pretrainer:
    """MoCo pretraining of ``encoder`` (its parameters filled, on its
    device) over a :class:`TwoViewPipeline` on the same device. ``seed``
    seeds the shuffle (numpy, as in JAX) and the device generator from
    which the queue and the views' flips and noises are drawn. The queue
    size rounds up to a multiple of the batch."""

    def __init__(self, encoder: nn.Module, hyperparams: Dict,
                 pipeline: TwoViewPipeline, queue_size: int = 2048,
                 momentum: float = 0.999, temperature: float = 0.07,
                 embed_dim: int = 128, seed: int = 0,
                 checkpoint_root: str = "./checkpoints", savename: str = "",
                 save_checkpoints: bool = True,
                 mesh: Optional[mesh_lib.Mesh] = None):
        self.encoder = encoder
        self.mesh = mesh
        self.rank = mesh.rank if mesh is not None else 0
        self.hp = hyperparams
        self.pipeline = pipeline
        self.momentum = momentum
        self.temperature = temperature
        self.checkpoint_root = checkpoint_root
        self.savename = savename
        self.save_checkpoints = save_checkpoints
        self.best_checkpoint: Optional[str] = None
        self.device = next(encoder.parameters()).device
        if pipeline.device != self.device:
            raise ValueError("pipeline on {}, encoder on {}".format(
                pipeline.device, self.device))

        self.batch_size = int(hyperparams["batch_size"])
        if mesh is not None and self.batch_size % mesh.world_size:
            raise ValueError("batch size {} does not split over {} "
                             "ranks".format(self.batch_size,
                                            mesh.world_size))
        mesh_lib.broadcast_module(encoder, mesh)
        self.epochs = int(hyperparams["epoch"])
        self.base_lr = float(hyperparams["lr"])
        queue_size = -(-queue_size // self.batch_size) * self.batch_size
        self.losses: List[float] = []

        self.np_rng = np.random.RandomState(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.moco = init_moco_state(encoder, queue_size, embed_dim,
                                    self.generator)
        self.optimizer = torch.optim.Adam(encoder.parameters(),
                                          lr=self.base_lr,
                                          betas=(0.9, 0.999), eps=1e-8)

    def loss(self, views, valid: torch.Tensor) -> torch.Tensor:
        """The masked mean InfoNCE loss of one batch of ``views`` (the
        first four of ``make_views``); moves the MoCo state on."""
        logits, target, _, self.moco = moco_forward(
            self.encoder, self.moco, *views, momentum=self.momentum,
            temperature=self.temperature)
        losses = F.cross_entropy(logits, target, reduction="none")
        return ((losses * valid).sum()
                / mesh_lib.global_sum(valid.sum()).clamp_min(1.0))

    def _step(self, centers: torch.Tensor, valid: torch.Tensor,
              loss_sum: torch.Tensor, lr: float) -> torch.Tensor:
        """One optimizer step on the global batch ``centers``; returns
        ``loss_sum`` plus this step's loss (under a mesh, this rank's share
        of it), on the device."""
        with mesh_lib.engaged(self.mesh):
            centers = mesh_lib.shard_rows(centers)
            views = self.pipeline.make_views(self.generator, centers)[:4]
            self.encoder.train()
            loss = self.loss(views, mesh_lib.shard_rows(valid))
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        mesh_lib.all_reduce_grads(self.encoder, self.mesh)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        return loss_sum + loss.detach()

    def _save(self, state, kind: str, run: int, dataset_name: str,
              epoch: int, loss: float) -> Optional[str]:
        if self.rank != 0:
            return None
        return ckpt.save_checkpoint(
            state_dict_to_flax(self.encoder, state), self.checkpoint_root,
            type(self.encoder).__name__.lower(), dataset_name, "pre_train",
            kind, self.savename, run, epoch, loss)

    def fit(self, run: int = 0, dataset_name: str = "dataset",
            log_every: int = 0) -> Dict[str, torch.Tensor]:
        """Pretrain ``hyperparams["epoch"]`` epochs; returns the
        state_dict (host copies) of the epoch with the best loss."""
        best_loss = 100.0
        best_state = _host_state(self.encoder)
        bs = self.batch_size
        for e in range(1, self.epochs + 1):
            lr = adjust_learning_rate(self.base_lr, e - 1, self.hp)
            order = self.pipeline.epoch_order(self.np_rng)
            centers_all, valid_all = _pad_to_multiple(order, bs)
            centers_all = torch.as_tensor(centers_all, device=self.device)
            valid_all = torch.as_tensor(valid_all, device=self.device)
            loss_sum = torch.zeros((), device=self.device)
            n_steps = 0
            for i in range(0, len(centers_all), bs):
                loss_sum = self._step(centers_all[i:i + bs],
                                      valid_all[i:i + bs], loss_sum, lr)
                n_steps += 1
            if self.mesh is not None:
                self.mesh.sum_(loss_sum)          # the ranks' shares
            avg = float(loss_sum) / max(n_steps, 1)
            self.losses.append(avg)
            if log_every and e % log_every == 0 and self.rank == 0:
                print("pretrain epoch {}/{} loss {:.4f} lr {:.2e}".format(
                    e, self.epochs, avg, lr), file=sys.stderr, flush=True)
            if abs(avg) <= best_loss:           # <= tie rule, ref :826
                best_loss = abs(avg)
                best_state = _host_state(self.encoder)
                if self.save_checkpoints:
                    self.best_checkpoint = self._save(
                        best_state, "best_epoch", run, dataset_name, e,
                        best_loss)
            if e in SNAPSHOT_EPOCHS and self.save_checkpoints:
                self._save(_host_state(self.encoder), "final_epoch", run,
                           dataset_name, e, abs(avg))
        return best_state
