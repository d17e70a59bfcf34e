"""Training loop with per-epoch validation and best-val tracking.

Port of :class:`vit_cnn_tpu.train.loop.Trainer` (ref: model_utils.py:854-
1045 train, :1135-1158 val). One step is the JAX ``Trainer._step``:

  patch gather with flip/rotate folded in, then radiation and mixture
     noise when configured (PatchPipeline.make_batch)
  -> forward in train mode (BatchNorm on batch statistics, running
     statistics updated; the zoo's dropout and Gumbel noise drawn from
     ``noise``), under the bf16 policy over float32 master weights when
     ``hyperparams["bf16"]``
  -> the model's loss (weighted cross-entropy, or ``glt`` for GLT_Net's
     (logits, con_loss)) with the padded tail masked by ``valid``
  -> backward (on CUDA through the kernels' adjoints)
  -> AdamW / Adam / SGD at the StepLR rate of this step.

The model and its optimizer are the train state (no twin of
``train/state.py``). The epoch loss sums on the device: the host reads it
once per epoch, so steps are queued without a host sync. ``fit`` returns
the best-validation ``state_dict`` (host copies) and, as the JAX loop
does, writes the best-epoch and final-epoch checkpoint files
(train/checkpoint.py) under ``checkpoint_root``, ``./checkpoints`` of the
working directory by default. ``save_resumable`` / ``restore_resumable``
write and read the whole train state: model, optimizer state (Adam's
moments or SGD's momentum trace), step, the shuffle's RandomState and
the device generator (the augmentation's and the noise's). With
``hyperparams["debug_nans"]`` the step stops at the first NaN, as
``jax_debug_nans`` does (:mod:`..utils.nancheck`).

With ``mesh`` (:mod:`..parallel.mesh`, every rank running the same
Trainer) the step is data parallel, as the JAX Trainer's over its
``data`` mesh: each rank gathers its rows of the global batch of centers
(a batch size the ranks do not divide raises), the draws, BatchNorm's
statistics and the loss's denominators are the global batch's, and after
the backward (and the zero-filling of unreached gradients) the gradients
are summed over the ranks, so every rank takes the same optimizer step.
The generator, the shuffle's RandomState and the model stay replicated
(rank 0's model is broadcast at the start); the epoch loss is the global
one; validation runs whole on every rank, so every rank picks the same
best epoch. Only rank 0 writes the best, final and resumable files and
prints; every rank can restore a resumable file.

While a profiler runs, each step and its batch assembly, forward and
loss, backward and optimizer are named ranges (:data:`STEP_SPAN` and the
others below).
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..convert import state_dict_to_flax
from ..nn import noise
from ..nn.precision import bf16_train_apply
from ..parallel import mesh as mesh_lib
from ..pipeline.patches import PatchPipeline
from ..utils import nancheck
from ..utils.profiling import span
from . import checkpoint as ckpt
from .losses import LOSSES
from .optim import OptimizerSpec, build_lr_schedule, build_optimizer


#: profiler ranges of one optimizer step (:meth:`Trainer._step`) and of
#: its batch assembly, forward and loss, backward (with the mesh's
#: gradient sum) and optimizer
STEP_SPAN = "trainer.step"
BATCH_SPAN = "trainer.batch"
FORWARD_SPAN = "trainer.forward"
BACKWARD_SPAN = "trainer.backward"
OPTIMIZER_SPAN = "trainer.optimizer"


@dataclasses.dataclass
class TrainLog:
    losses: List[float] = dataclasses.field(default_factory=list)
    val_accuracies: List[float] = dataclasses.field(default_factory=list)
    epoch_seconds: List[float] = dataclasses.field(default_factory=list)


def _pad_to_multiple(arr: np.ndarray, multiple: int):
    """Pad ``arr`` to a multiple of ``multiple`` rows by repeating its
    first row; returns (padded, valid) with valid 0 on the padding."""
    n = len(arr)
    rem = (-n) % multiple
    if rem == 0:
        return arr, np.ones(n, dtype=np.float32)
    pad = np.repeat(arr[:1], rem, axis=0)
    valid = np.concatenate([np.ones(n, dtype=np.float32),
                            np.zeros(rem, dtype=np.float32)])
    return np.concatenate([arr, pad], axis=0), valid


def _host_state(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True)
            for k, v in model.state_dict().items()}


class Trainer:
    """Trains one (model, pipeline) pair on the model's device. The model
    arrives with its parameters filled (``init_parameters`` or
    ``load_state_dict``); ``seed`` seeds the shuffle (numpy) and one
    torch.Generator on the device, ``generator``, from which both the
    augmentation and the zoo's dropout and Gumbel noise draw, in step
    order. ``noise`` is the source of the forward's draws (:mod:`..nn.
    noise`): ``generator`` unless a caller sets a Recorder or Replay."""

    def __init__(self, model: torch.nn.Module, hyperparams: Dict,
                 pipeline: PatchPipeline,
                 val_pipeline: Optional[PatchPipeline] = None,
                 seed: int = 0, checkpoint_root: str = "./checkpoints",
                 savename: str = "", save_checkpoints: bool = True,
                 mesh: Optional[mesh_lib.Mesh] = None):
        self.checkpoint_root = checkpoint_root
        self.savename = savename
        self.save_checkpoints = save_checkpoints
        self.best_checkpoint: Optional[str] = None
        self.final_checkpoint: Optional[str] = None
        loss = hyperparams.get("loss", "cross_entropy")
        if loss not in LOSSES or loss == "focal":
            # focal_loss takes (logits, targets, gamma, alpha, ...), not the
            # (output, labels, class_weights, valid) of a step: the JAX
            # Trainer would pass the class weights as gamma
            raise NotImplementedError(
                "loss {!r}: the Trainer takes {} (focal: ROADMAP Queue 1, "
                "'Not ported yet')"
                .format(loss, sorted(set(LOSSES) - {"focal"})))
        self.model = model
        self.pipeline = pipeline
        self.val_pipeline = val_pipeline
        self.log = TrainLog()
        self.device = next(model.parameters()).device
        if pipeline.device != self.device:
            raise ValueError("pipeline on {}, model on {}".format(
                pipeline.device, self.device))

        self.batch_size = int(hyperparams["batch_size"])
        self.mesh = mesh
        self.rank = mesh.rank if mesh is not None else 0
        if mesh is not None and self.batch_size % mesh.world_size:
            raise ValueError("batch size {} does not split over {} "
                             "ranks".format(self.batch_size,
                                            mesh.world_size))
        mesh_lib.broadcast_module(model, mesh)
        self.epochs = int(hyperparams["epoch"])
        self.loss_fn = LOSSES[loss]
        self.class_weights = torch.as_tensor(
            np.asarray(hyperparams["weights"], np.float32),
            device=self.device)

        steps_per_epoch = max(len(pipeline) // self.batch_size, 1)
        spec = OptimizerSpec(
            name=hyperparams.get("optimizer", "adam"),
            lr=float(hyperparams["lr"]),
            weight_decay=float(hyperparams.get("weight_decay", 0.0)),
            step_size=hyperparams.get("scheduler_step", 30),
            gamma=hyperparams.get("scheduler_gamma", 0.9))
        self.schedule = build_lr_schedule(spec, steps_per_epoch)
        self.optimizer = build_optimizer(spec, model.parameters())
        self.steps_done = 0
        self.np_rng = np.random.RandomState(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.noise: noise.Source = self.generator

        self.bf16 = bool(hyperparams.get("bf16"))
        if self.bf16:
            if pipeline is val_pipeline:
                raise ValueError("bf16 training casts the train pipeline's "
                                 "scenes; pass a separate val_pipeline so "
                                 "evaluation gathers stay float32")
            pipeline.to_compute_dtype(torch.bfloat16)
        self._forward = bf16_train_apply(model) if self.bf16 else model
        self.debug_nans = bool(hyperparams.get("debug_nans"))
        if self.debug_nans:
            nancheck.watch(model)

    # ------------------------------------------------------------------
    def _step(self, centers: torch.Tensor, valid: torch.Tensor,
              loss_sum: torch.Tensor) -> torch.Tensor:
        """One optimizer step on the global batch ``centers`` (device int
        tensor); returns ``loss_sum`` plus this step's loss (under a mesh,
        this rank's share of it), on the device."""
        with span(STEP_SPAN), mesh_lib.engaged(self.mesh):
            centers = mesh_lib.shard_rows(centers)
            valid = mesh_lib.shard_rows(valid)
            with span(BATCH_SPAN):
                p1, p2, labels = self.pipeline.make_batch(
                    self.generator, centers, train=True)
            self.model.train()
            with span(FORWARD_SPAN):
                with noise.drawing(self.noise):
                    out = self._forward(p1, p2)
                loss = self.loss_fn(out, labels, self.class_weights, valid)
            with span(BACKWARD_SPAN):
                self.optimizer.zero_grad(set_to_none=True)
                if self.debug_nans:
                    nancheck.check(loss, "the loss")
                    nancheck.backward(loss)
                else:
                    loss.backward()
                for p in self.model.parameters():
                    if p.grad is None:
                        # a parameter the loss does not reach (S2EFT's
                        # gate conv, behind its hard gate) gets a zero
                        # gradient, as jax.grad gives it, so the optimizer
                        # steps every parameter
                        p.grad = torch.zeros_like(p)
                mesh_lib.all_reduce_grads(self.model, self.mesh)
            with span(OPTIMIZER_SPAN):
                for group in self.optimizer.param_groups:
                    group["lr"] = self.schedule(self.steps_done)
                self.optimizer.step()
            if self.debug_nans:
                nancheck.check_parameters(self.model)
            self.steps_done += 1
            return loss_sum + loss.detach()

    @torch.no_grad()
    def validate(self) -> float:
        """Accuracy of the float32 eval-mode model on the val centers;
        predictions in ignored labels are skipped (ref: model_utils.py:
        1152-1157)."""
        vp = self.val_pipeline
        if vp is None or len(vp) == 0:
            return 0.0
        self.model.eval()
        bs = self.batch_size
        centers_all, valid_all = _pad_to_multiple(vp.indices, bs)
        centers_all = torch.as_tensor(centers_all, device=self.device)
        valid_all = torch.as_tensor(valid_all, device=self.device)
        correct = torch.zeros((), dtype=torch.long, device=self.device)
        total = torch.zeros((), dtype=torch.long, device=self.device)
        for i in range(0, len(centers_all), bs):
            p1, p2, labels = vp.make_batch(None, centers_all[i:i + bs],
                                           train=False)
            out = self.model(p1, p2)
            logits = out[0] if isinstance(out, tuple) else out
            pred = logits.argmax(dim=-1)
            keep = ~vp.ignored_mask[pred] & (valid_all[i:i + bs] > 0)
            correct += ((pred == labels) & keep).sum()
            total += keep.sum()
        return int(correct) / max(int(total), 1)

    # ------------------------------------------------------------------
    # Resumable state: the whole train state and both random streams, so a
    # restarted run continues with the same shuffle order and augmentation
    # draws (the JAX loop's save_resumable / restore_resumable).
    def save_resumable(self, path: str, epoch: int) -> str:
        rng_state = self.np_rng.get_state()
        extra = {"epoch": epoch,
                 "np_rng": [rng_state[0], np.asarray(rng_state[1]).tolist(),
                            int(rng_state[2]), int(rng_state[3]),
                            float(rng_state[4])],
                 "generator": self.generator.get_state().tolist()}
        if self.rank == 0:
            path = ckpt.save_train_state(path, self.model, self.optimizer,
                                         self.steps_done, extra)
        if self.mesh is not None:
            # the file is written before any rank reads it
            path = self.mesh.broadcast_object(path)
        return path

    def restore_resumable(self, path: str) -> int:
        """Returns the epoch to resume FROM (0 without metadata)."""
        self.steps_done, extra = ckpt.restore_train_state(
            path, self.model, self.optimizer)
        if not extra:
            return 0
        s = extra["np_rng"]
        self.np_rng.set_state((s[0], np.asarray(s[1], dtype=np.uint32),
                               int(s[2]), int(s[3]), float(s[4])))
        self.generator.set_state(torch.tensor(extra["generator"],
                                              dtype=torch.uint8))
        return int(extra["epoch"])

    def _save(self, state: Dict[str, torch.Tensor], kind: str, run: int,
              dataset_name: str, epoch: int, metric: float) -> Optional[str]:
        if self.rank != 0:
            return None
        return ckpt.save_checkpoint(
            state_dict_to_flax(self.model, state), self.checkpoint_root,
            type(self.model).__name__.lower(), dataset_name, "train", kind,
            self.savename, run, epoch, metric)

    # ------------------------------------------------------------------
    def fit(self, run: int = 0, dataset_name: str = "dataset",
            log_every: int = 0, on_epoch_end: Optional[Callable] = None,
            start_epoch: int = 0) -> Dict[str, torch.Tensor]:
        """Train epochs ``start_epoch + 1`` to ``hyperparams["epoch"]``;
        returns the state_dict of the epoch with the best metric, compared
        as ``abs(metric) >= best`` as the JAX loop does (later epochs win
        ties): the val accuracy, or -loss without a val pipeline. With
        ``save_checkpoints``, each new best is written to ``best_epoch``
        and the last epoch to ``final_epoch`` (paths in
        ``best_checkpoint`` / ``final_checkpoint``). ``start_epoch`` > 0
        continues a run restored with :meth:`restore_resumable`."""
        best_metric = 0.0
        best_state = _host_state(self.model)
        bs = self.batch_size
        for epoch in range(start_epoch + 1, self.epochs + 1):
            t0 = time.time()
            order = self.pipeline.epoch_order(self.np_rng)
            centers_all, valid_all = _pad_to_multiple(order, bs)
            centers_all = torch.as_tensor(centers_all, device=self.device)
            valid_all = torch.as_tensor(valid_all, device=self.device)
            loss_sum = torch.zeros((), device=self.device)
            n_steps = 0
            for i in range(0, len(centers_all), bs):
                loss_sum = self._step(centers_all[i:i + bs],
                                      valid_all[i:i + bs], loss_sum)
                n_steps += 1
            if self.mesh is not None:
                self.mesh.sum_(loss_sum)          # the ranks' shares
            avg_loss = float(loss_sum) / n_steps if n_steps else 0.0
            self.log.losses.append(avg_loss)

            if self.val_pipeline is not None:
                metric = self.validate()
                self.log.val_accuracies.append(metric)
            else:
                metric = -avg_loss
            self.log.epoch_seconds.append(time.time() - t0)
            if log_every and epoch % log_every == 0 and self.rank == 0:
                secs = self.log.epoch_seconds[-1]
                print("epoch {}/{} loss {:.4f} val {:.4f} ({:.2f}s, {:.0f} "
                      "patches/s)".format(
                          epoch, self.epochs, avg_loss,
                          self.log.val_accuracies[-1]
                          if self.log.val_accuracies else float("nan"),
                          secs, len(self.pipeline) / max(secs, 1e-9)),
                      file=sys.stderr, flush=True)
            if abs(metric) >= best_metric:
                best_metric = abs(metric)
                best_state = _host_state(self.model)
                if self.save_checkpoints:
                    self.best_checkpoint = self._save(
                        best_state, "best_epoch", run, dataset_name, epoch,
                        best_metric)
            if epoch == self.epochs and self.save_checkpoints:
                self.final_checkpoint = self._save(
                    _host_state(self.model), "final_epoch", run,
                    dataset_name, epoch, abs(metric))
            if on_epoch_end is not None:
                on_epoch_end(epoch, avg_loss, metric)
        return best_state

