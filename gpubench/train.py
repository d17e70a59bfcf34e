"""The generator of training traffic (``kind`` "train"): epochs of the
scene's training split through the port's ``Trainer``, as
``Trainer.fit`` runs them, without validation or checkpoints.

An epoch is the Trainer's shuffle of the split (``epoch_order`` on its
seeded RandomState), padded to whole batches by repeating its first row
with ``valid`` 0 (``fit``'s ``_pad_to_multiple``), the batches stepped by
``Trainer._step`` (gather, forward under the bf16 training policy, loss,
backward, optimizer) and the epoch loss read once on the host.

Set-up builds the one Trainer that the window goes on with and runs the
first epoch through the same call; its first three steps are what
``correct`` follows (:meth:`Train.check`): each step's loss, the first
gradient as Adam holds it after one step (``exp_avg / (1 - beta1)``), the
parameters' change over the three steps and the BatchNorm statistics'
change apart, against the configuration's plain float32 reference driven
through the same three batches from the same scene and weights
(:meth:`Train.numbers`; the cell's limits name the numbers compared). The
window then runs whole epochs until one ends at or after ``seconds``.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from . import layout, scene as scene_lib, weights as weights_lib
from .precision import MODES

#: steps of the first epoch that the check follows
CHECKED_STEPS = 3
BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


def interior(gt: np.ndarray, patch: int) -> np.ndarray:
    """(N, 2) labelled centres strictly inside the border, row-major (the
    port's ``pipeline/patches.interior_indices`` for label 0 ignored)."""
    x, y = np.nonzero(gt)
    p = patch // 2
    h, w = gt.shape
    keep = (x > p) & (x < h - p) & (y > p) & (y < w - p)
    return np.stack([x[keep], y[keep]], axis=1).astype(np.int32)


def padded(order: np.ndarray, batch: int):
    """``order`` padded to a multiple of ``batch`` rows by its first row,
    and the valid mask (1 on the real rows)."""
    rem = -len(order) % batch
    valid = np.concatenate([np.ones(len(order), np.float32),
                            np.zeros(rem, np.float32)])
    return np.concatenate([order, np.repeat(order[:1], rem, 0)]), valid


def gather(img: torch.Tensor, centers: torch.Tensor, patch: int):
    """(B, P, P, C) patches around (B, 2) centres, clamped to the scene."""
    d = torch.arange(patch, device=img.device) - patch // 2
    r = (centers[:, 0, None, None] + d[None, :, None]).clamp(0,
                                                              img.shape[0] - 1)
    c = (centers[:, 1, None, None] + d[None, None, :]).clamp(0,
                                                              img.shape[1] - 1)
    return img[r, c]


def leaf_gaps(prog: Dict, ref: Dict, keys) -> List[float]:
    """Per leaf of ``keys``, | |prog| - |ref| | over the larger of the
    reference leaf's norm and the median of the reference's norms over
    ``keys`` (norms in float64)."""
    pn = {k: float(prog[k].double().norm()) for k in keys}
    rn = {k: float(ref[k].double().norm()) for k in keys}
    med = float(np.median(list(rn.values())))
    return [abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys]


def distance(prog: Dict, ref: Dict, keys) -> float:
    """||prog - ref|| over ||ref||, the leaves of ``keys`` taken as one
    vector (float64)."""
    num = sum(float((prog[k].double() - ref[k].double()).pow(2).sum())
              for k in keys)
    den = sum(float(ref[k].double().pow(2).sum()) for k in keys)
    return (num / max(den, 1e-300)) ** 0.5


class Train:
    #: the mix's keys that this generator reads
    KEYS = ("kind", "batch_size", "precision", "flip", "trace_epochs")
    FIXED: Dict = {}

    def __init__(self, info: Dict, seed: int, device, fault=None):
        self.cfg, self.mix = info["config"], info["traffic"]
        self.seed, self.device = int(seed), torch.device(device)
        self.fault = fault
        self.work: Dict = {}

    # ------------------------------------------------------------ set-up
    def prepare(self):
        """The scene, the model (parameters not filled), its settings."""
        from vit_cnn_tpu_torch.models.registry import get_model

        cfg, mix = self.cfg, self.mix
        self.patch = int(cfg["patch_size"])
        self.scene = scene_lib.make(cfg["scene"], self.seed, self.device,
                                    margin=self.patch // 2 + 1)
        img1, img2 = self.scene["img1"], self.scene["img2"]
        net, _, hp = get_model(
            cfg["model"], dataset="gpubench", n_classes=cfg["n_classes"],
            n_bands=(img1.shape[2], img2.shape[2]), ignored_labels=[0],
            batch_size=int(mix["batch_size"]), epoch=1 << 30,
            bf16=mix["precision"] == "bfloat16",
            flip_augmentation=bool(mix["flip"]))
        self.hp = hp
        self.shapes = {k: tuple(v.shape) for k, v in net.state_dict().items()}
        self.batch = int(mix["batch_size"])
        self.indices = interior(self.scene["gt_train"], self.patch)
        self.steps_per_epoch = -(-len(self.indices) // self.batch)
        return net

    def setup(self) -> None:
        from vit_cnn_tpu_torch.pipeline.patches import (AugmentConfig,
                                                        PatchPipeline)
        from vit_cnn_tpu_torch.train.loop import Trainer

        net = self.prepare()
        net.to(self.device)
        net.load_state_dict(weights_lib.seeded_state(self.shapes, self.seed,
                                                     self.device))
        pipe = PatchPipeline(
            self.scene["img1"], self.scene["img2"], self.scene["gt_train"],
            self.patch, [0], int(self.cfg["n_classes"]),
            augment=AugmentConfig(flip=bool(self.mix["flip"])),
            device=self.device)
        self.trainer = Trainer(net, self.hp, pipe, seed=self.seed % 2 ** 32,
                               save_checkpoints=False)
        if self.fault is not None:
            self.fault(self.trainer)
        self.epoch(record=True)
        self.sync()

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _snapshot(self, what: str) -> Dict[str, torch.Tensor]:
        t = self.trainer
        if what == "grad":
            beta1 = BETAS[0]
            return {n: (t.optimizer.state[p]["exp_avg"] / (1 - beta1))
                    .detach().float().cpu()
                    for n, p in t.model.named_parameters()}
        return {n: v.detach().to("cpu", torch.float32, copy=True)
                for n, v in t.model.state_dict().items()}

    def epoch(self, record: bool = False) -> float:
        """One epoch as ``Trainer.fit`` runs it; its loss, read once.
        With ``record``, each checked step's loss, the first gradient and
        the state after the checked steps are kept (set-up only)."""
        t = self.trainer
        order = t.pipeline.epoch_order(t.np_rng)
        centers, valid = padded(order, self.batch)
        centers = torch.as_tensor(centers, device=self.device)
        valid = torch.as_tensor(valid, device=self.device)
        loss_sum = torch.zeros((), device=self.device)
        losses, n = [], 0
        for i in range(0, len(centers), self.batch):
            loss_sum = t._step(centers[i:i + self.batch],
                               valid[i:i + self.batch], loss_sum)
            n += 1
            if record and n <= CHECKED_STEPS:
                losses.append(float(loss_sum) - sum(losses))
                if n == 1:
                    self.grad1 = self._snapshot("grad")
                if n == CHECKED_STEPS:
                    self.state3 = self._snapshot("state")
        if record:
            self.losses = losses
        return float(loss_sum) / n

    # ------------------------------------------------------------ window
    def window(self, seconds: float, tracer=None) -> Dict:
        """Whole epochs until one ends at or after ``seconds``; with
        ``tracer`` the profiler starts with the first epoch and the next
        ``trace_epochs`` run inside its traced span (the window goes on
        until they have)."""
        n_traced = int(self.mix["trace_epochs"]) if tracer else 0
        epochs = 0
        t0 = time.perf_counter()
        if tracer:
            tracer.start()
        while True:
            if 1 <= epochs <= n_traced:
                with tracer.span():
                    self.epoch()
            else:
                self.epoch()
            epochs += 1
            if time.perf_counter() - t0 >= seconds and epochs > n_traced:
                break
        elapsed = time.perf_counter() - t0
        valid = len(self.indices)
        steps = self.steps_per_epoch
        self.work = {"attempted": epochs * steps, "epochs": epochs,
                     "valid_patches": epochs * valid, "seconds": elapsed,
                     "traced": {"epochs": n_traced, "steps": n_traced * steps,
                                "valid_patches": n_traced * valid,
                                "patches": n_traced * steps * self.batch}}
        return {"train_patches_per_s": epochs * valid / elapsed}

    def release(self) -> None:
        del self.trainer
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- check
    def reference_steps(self, mode: str = "float32"):
        """The reference's three steps from the seed's weights: per-step
        losses, the first gradients and the state after the third step."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ref = layout.module("reference", self.cfg["name"])
        mm = MODES[mode]
        sd = weights_lib.seeded_state(self.shapes, self.seed, self.device)
        stats = [k for k in sd if k.endswith(("running_mean",
                                              "running_var"))]
        params = {k: v.requires_grad_() for k, v in sd.items()
                  if k not in stats}
        img1 = torch.from_numpy(self.scene["img1"]).to(self.device)
        img2 = torch.from_numpy(self.scene["img2"]).to(self.device)
        gt = torch.from_numpy(self.scene["gt_train"]).to(self.device)
        order = self.indices[np.random.RandomState(
            self.seed % 2 ** 32).permutation(len(self.indices))]
        centers, valid = padded(order, self.batch)
        centers = torch.as_tensor(centers, dtype=torch.long,
                                  device=self.device)
        valid = torch.as_tensor(valid, device=self.device)
        weights = torch.ones(int(self.cfg["n_classes"]), device=self.device)
        weights[0] = 0.0
        m = {k: torch.zeros_like(v) for k, v in params.items()}
        v2 = {k: torch.zeros_like(v) for k, v in params.items()}
        lr0 = float(self.hp["lr"])
        per_epoch = max(len(self.indices) // self.batch, 1)
        losses, grad1 = [], None
        for step in range(CHECKED_STEPS):
            c = centers[step * self.batch:(step + 1) * self.batch]
            ok = valid[step * self.batch:(step + 1) * self.batch]
            x1, x2 = gather(img1, c, self.patch), gather(img2, c, self.patch)
            labels = gt[c[:, 0], c[:, 1]]
            logits, new_stats = ref.train_forward({**sd, **params}, x1, x2,
                                                  mm)
            w = weights[labels] * ok
            nll = -torch.log_softmax(logits, dim=-1).gather(
                -1, labels[:, None])[:, 0]
            loss = (w * nll).sum() / w.sum().clamp_min(1e-12)
            grads = torch.autograd.grad(loss, list(params.values()))
            losses.append(float(loss.detach()))
            if grad1 is None:
                grad1 = {k: g.detach().cpu()
                         for k, g in zip(params, grads)}
            lr = lr0 * float(self.hp.get("scheduler_gamma", 0.9)) ** (
                (step // per_epoch) // int(self.hp.get("scheduler_step", 30)))
            t = step + 1
            with torch.no_grad():
                for (k, p), g in zip(params.items(), grads):
                    m[k].mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
                    v2[k].mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
                    denom = (v2[k].sqrt() / (1 - BETAS[1] ** t) ** 0.5).add_(
                        ADAM_EPS)
                    p.addcdiv_(m[k], denom, value=-lr / (1 - BETAS[0] ** t))
                for k in stats:
                    sd[k] = new_stats[k].detach()
        state3 = {k: (params[k] if k in params else sd[k]).detach().cpu()
                  for k in sd}
        return losses, grad1, state3

    def numbers(self, losses, grad1, state3, ref) -> Dict:
        """The gaps of a run (``losses``, ``grad1``, ``state3``) to the
        reference's (``ref``, from :meth:`reference_steps`).

        Over the parameters whose reference gradient counts (below): the
        median leaf's gap of the first gradient's norm (``grad_gap``) and
        of the parameters' change over the three steps (``change_gap``),
        the worst leaf's (``*_worst``, with its name in ``*_worst_at``)
        and the whole vector's relative distance, ||prog - ref|| over
        ||ref|| (``*_dir``, which sees a change in direction that the
        norms do not). The BatchNorm statistics' change apart
        (``stats_gap``, ``stats_worst``). ``loss_gap`` is the first
        step's loss, ``loss3_gap`` the worst of the three."""
        r_losses, r_grad1, r_state3 = ref
        start = {k: v.cpu() for k, v in weights_lib.seeded_state(
            self.shapes, self.seed, self.device).items()}
        keys = list(r_grad1)
        gn = {k: float(r_grad1[k].double().norm()) for k in keys}
        med = float(np.median(list(gn.values())))
        # leaves whose reference gradient is nought to rounding (a conv's
        # bias ahead of a train-mode BatchNorm) move under Adam by
        # rounding alone: their gradient and change are not compared
        counted = [k for k in keys if gn[k] >= 1e-3 * med]
        stats = [k for k in state3 if k not in r_grad1]
        d_prog = {k: state3[k] - start[k] for k in counted + stats}
        d_ref = {k: r_state3[k] - start[k] for k in counted + stats}
        out = {}
        for name, prog, want, leaves in (
                ("grad", grad1, r_grad1, counted),
                ("change", d_prog, d_ref, counted),
                ("stats", d_prog, d_ref, stats)):
            gaps = leaf_gaps(prog, want, leaves)
            worst = int(np.argmax(gaps))
            out[name + "_gap"] = float(np.median(gaps))
            out[name + "_worst"] = gaps[worst]
            out[name + "_worst_at"] = leaves[worst]
            if name != "stats":
                out[name + "_dir"] = distance(prog, want, leaves)
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, r_losses)]
        out.update(loss_gap=rel[0], loss3_gap=max(rel))
        return out

    def check(self) -> Dict:
        ref = self.reference_steps()
        return self.numbers(self.losses, self.grad1, self.state3, ref)

    def control(self, mode: str) -> Dict[str, float]:
        """The control's numbers: the reference with ``mode`` products in
        the program's place; with ``mode`` "program" the program's own
        (set-up with ``fault`` where one is given)."""
        if mode == "program":
            self.setup()
            self.release()
            return self.check()
        self.prepare()
        return self.numbers(*self.reference_steps(mode),
                            self.reference_steps())
