"""Training loop with per-epoch validation and best-val tracking.

Port of :class:`vit_cnn_tpu.train.loop.Trainer` (ref: model_utils.py:854-
1045 train, :1135-1158 val). One step is the JAX ``Trainer._step``:

  patch gather with flip/rotate folded in (PatchPipeline.make_batch)
  -> forward in train mode (BatchNorm on batch statistics, running
     statistics updated), under the bf16 policy over float32 master
     weights when ``hyperparams["bf16"]``
  -> weighted cross-entropy with the padded tail masked by ``valid``
  -> backward (on CUDA through the kernels' adjoints)
  -> AdamW / Adam at the StepLR rate of this step.

The model and its optimizer are the train state (no twin of
``train/state.py``). The epoch loss sums on the device: the host reads it
once per epoch, so steps are queued without a host sync. ``fit`` returns
the best-validation ``state_dict`` (host copies). Checkpoint files and
resumable state are ROADMAP Queue 1, '--restore'.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..nn.precision import bf16_train_apply
from ..pipeline.patches import PatchPipeline
from .losses import LOSSES
from .optim import OptimizerSpec, build_lr_schedule, build_optimizer


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
    ``load_state_dict``); ``seed`` seeds the shuffle (numpy) and the
    augmentation draws (a torch.Generator on the device)."""

    def __init__(self, model: torch.nn.Module, hyperparams: Dict,
                 pipeline: PatchPipeline,
                 val_pipeline: Optional[PatchPipeline] = None,
                 seed: int = 0, save_checkpoints: bool = False):
        if save_checkpoints:
            raise NotImplementedError(
                "checkpoint files are not ported yet: ROADMAP Queue 1, "
                "'--restore'")
        loss = hyperparams.get("loss", "cross_entropy")
        if loss not in LOSSES:
            raise NotImplementedError(
                "loss {!r} is not ported yet: it comes with its model "
                "(ROADMAP Queue 1)".format(loss))
        self.model = model
        self.pipeline = pipeline
        self.val_pipeline = val_pipeline
        self.log = TrainLog()
        self.device = next(model.parameters()).device
        if pipeline.device != self.device:
            raise ValueError("pipeline on {}, model on {}".format(
                pipeline.device, self.device))

        self.batch_size = int(hyperparams["batch_size"])
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

        self.bf16 = bool(hyperparams.get("bf16"))
        if self.bf16:
            if pipeline is val_pipeline:
                raise ValueError("bf16 training casts the train pipeline's "
                                 "scenes; pass a separate val_pipeline so "
                                 "evaluation gathers stay float32")
            pipeline.to_compute_dtype(torch.bfloat16)
        self._forward = bf16_train_apply(model) if self.bf16 else model

    # ------------------------------------------------------------------
    def _step(self, centers: torch.Tensor, valid: torch.Tensor,
              loss_sum: torch.Tensor) -> torch.Tensor:
        """One optimizer step on ``centers`` (device int tensor); returns
        ``loss_sum`` plus this step's loss, on the device."""
        p1, p2, labels = self.pipeline.make_batch(self.generator, centers,
                                                  train=True)
        self.model.train()
        out = self._forward(p1, p2)
        loss = self.loss_fn(out, labels, self.class_weights, valid)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.steps_done)
        self.optimizer.step()
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
    def fit(self, log_every: int = 0,
            on_epoch_end: Optional[Callable] = None
            ) -> Dict[str, torch.Tensor]:
        """Train for ``hyperparams["epoch"]`` epochs; returns the state_dict
        of the epoch with the best metric, compared as ``abs(metric) >=
        best`` as the JAX loop does (later epochs win ties): the val
        accuracy, or -loss without a val pipeline."""
        best_metric = 0.0
        best_state = _host_state(self.model)
        bs = self.batch_size
        for epoch in range(1, self.epochs + 1):
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
            avg_loss = float(loss_sum) / n_steps if n_steps else 0.0
            self.log.losses.append(avg_loss)

            if self.val_pipeline is not None:
                metric = self.validate()
                self.log.val_accuracies.append(metric)
            else:
                metric = -avg_loss
            self.log.epoch_seconds.append(time.time() - t0)
            if log_every and epoch % log_every == 0:
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
            if on_epoch_end is not None:
                on_epoch_end(epoch, avg_loss, metric)
        return best_state

