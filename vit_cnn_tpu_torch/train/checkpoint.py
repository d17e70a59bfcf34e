"""Checkpoint files in the JAX package's format and places.

Port of :mod:`vit_cnn_tpu.train.checkpoint`. A checkpoint is the flax
variable tree of the model (``convert.state_dict_to_flax``), written as
``flax.serialization.to_bytes`` writes it (:mod:`.msgpack`), under the
same directory scheme and file name (ref: model_utils.py:1015-1064)::

  {root}/{model class name, lower case}/{dataset}/train/
      {best_epoch|final_epoch}/{time}{savename}_run{r}_epoch{e}_{metric:.2f}.msgpack

with every map's keys sorted as ``jax.device_get`` leaves them, so the
same weights give the same bytes as the JAX package's file, and each
package reads the other's files. Restoring is strict both ways: a
missing or an extra entry raises (``convert.flax_to_state_dict``).

Resumable state (:func:`save_train_state`) takes the JAX package's
fallback layout (no orbax): one ``<path>.msgpack`` with ``params``,
``batch_stats``, ``opt_state`` and ``step``, and ``<path>.msgpack.meta.json``
beside it. ``opt_state`` holds the Adam / AdamW moments ``mu`` and ``nu``
as flax ``params`` trees, or SGD's momentum trace as ``trace`` (torch's
``momentum_buffer``, optax's ``TraceState.trace``), or nothing for SGD
at momentum 0; restoring into another kind of optimizer raises
``KeyError``. A JAX train state cannot be resumed here (its
augmentation draws come from a jax PRNG key), nor the reverse.
"""

from __future__ import annotations

import datetime
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..convert import flax_to_state_dict, state_dict_to_flax
from . import msgpack


def _sorted(tree: Any) -> Any:
    """``tree`` with every map's keys in sorted order, as the JAX package's
    ``jax.device_get`` hands its trees to flax: the same weights give the
    same file bytes on both sides."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def checkpoint_dir(root: str, model_name: str, dataset_name: str,
                   train_state: str = "train", kind: str = "best_epoch"
                   ) -> str:
    return os.path.join(root, model_name, dataset_name, train_state, kind)


def save_checkpoint(tree: Any, root: str, model_name: str,
                    dataset_name: str, train_state: str = "train",
                    kind: str = "best_epoch", savename: str = "",
                    run: int = 0, epoch: int = 0, metric: float = 0.0
                    ) -> str:
    """Write ``tree`` (a flax variable tree of numpy arrays); returns the
    file path (ref: model_utils.py:1056-1060)."""
    d = checkpoint_dir(root, model_name, dataset_name, train_state, kind)
    os.makedirs(d, exist_ok=True)
    time_str = datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
    fname = "{}{}_run{}_epoch{}_{:.2f}.msgpack".format(
        time_str, savename, run, epoch, metric)
    path = os.path.join(d, fname)
    with open(path, "wb") as f:
        f.write(msgpack.packb(_sorted(tree)))
    return path


def restore_checkpoint(path: str) -> Any:
    """The nested numpy tree of a checkpoint file (``--restore``)."""
    with open(path, "rb") as f:
        return msgpack.unpackb(f.read())


def restore_state_dict(path: str, model: torch.nn.Module
                       ) -> Dict[str, torch.Tensor]:
    """A checkpoint file as ``model``'s state_dict, strict both ways."""
    return flax_to_state_dict(restore_checkpoint(path), model)


# ---------------------------------------------------------------------------
# resumable state
# ---------------------------------------------------------------------------

_MOMENTS = (("mu", "exp_avg"), ("nu", "exp_avg_sq"))
_TRACE = (("trace", "momentum_buffer"),)


def _layout(optimizer: torch.optim.Optimizer):
    """The (tree, state key) pairs of ``optimizer``'s resumable state:
    Adam's and AdamW's moments; SGD's momentum trace, or nothing at
    momentum 0 (torch keeps no state then, and optax's chain has no
    ``trace``)."""
    if isinstance(optimizer, torch.optim.SGD):
        if any(g["momentum"] for g in optimizer.param_groups):
            return _TRACE
        return ()
    return _MOMENTS


def _optimizer_tree(model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer, step: int) -> Dict:
    """The optimizer's state of every parameter as flax trees (Adam's
    ``mu`` and ``nu``, SGD's ``trace``), each empty before the first
    step. Every parameter's own Adam step count must equal ``step``."""
    layout = _layout(optimizer)
    names = {id(p): k for k, p in model.named_parameters()}
    held = {names[id(p)]: s for p, s in optimizer.state.items() if s}
    if not held:
        if step and layout:
            raise ValueError("step {} but no optimizer state".format(step))
        return {tree: {} for tree, _ in layout}
    if set(held) != set(names.values()):
        raise ValueError("optimizer state for {} of {} parameters; a "
                         "resumable state needs all or none".format(
                             len(held), len(names)))
    if layout is _MOMENTS:
        off = sorted(k for k, s in held.items() if int(s["step"]) != step)
        if off:
            raise ValueError("parameters whose Adam step is not {}: {}"
                             .format(step, off))
    return {tree: state_dict_to_flax(model, {
        k: s[key] for k, s in held.items()})["params"]
        for tree, key in layout}


def _load_optimizer(model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer, opt_state: Dict,
                    step: int) -> None:
    layout = _layout(optimizer)
    want = {tree for tree, _ in layout}
    if set(opt_state) != want:
        raise KeyError("opt_state holds {}; a {} optimizer takes {}".format(
            sorted(opt_state), type(optimizer).__name__, sorted(want)))
    if not any(opt_state[tree] for tree in want):
        if step and layout:
            raise ValueError("step {} but no optimizer state".format(step))
        optimizer.state.clear()
        return
    params = dict(model.named_parameters())
    values = {key: flax_to_state_dict({"params": opt_state[tree]}, model,
                                      expected=params)
              for tree, key in layout}
    index = {k: i for i, (k, _) in enumerate(model.named_parameters())}
    order = [p for group in optimizer.param_groups for p in group["params"]]
    names = {id(p): k for k, p in params.items()}
    if [names[id(p)] for p in order] != list(index):
        raise ValueError("the optimizer does not hold the model's "
                         "parameters in module order")
    sd = optimizer.state_dict()
    sd["state"] = {index[k]: {key: values[key][k] for _, key in layout}
                   for k in params}
    if layout is _MOMENTS:
        for state in sd["state"].values():
            # a tensor each: Adam counts each parameter's steps in place
            state["step"] = torch.tensor(float(step))
    optimizer.load_state_dict(sd)


def save_train_state(path: str, model: torch.nn.Module,
                     optimizer: torch.optim.Optimizer, step: int,
                     extra: Optional[Dict] = None) -> str:
    """Write the model, its optimizer's state and ``step`` to
    ``<path>.msgpack`` (and ``extra`` as JSON to
    ``<path>.msgpack.meta.json``); returns the ``.msgpack`` path."""
    tree = state_dict_to_flax(model)
    payload = {"params": tree["params"], "batch_stats": tree["batch_stats"],
               "opt_state": _optimizer_tree(model, optimizer, step),
               "step": np.int32(step)}
    path = os.path.abspath(path) + ".msgpack"
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(msgpack.packb(_sorted(payload)))
    if extra is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(extra, f)
    return path


def restore_train_state(path: str, model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer
                        ) -> Tuple[int, Optional[Dict]]:
    """Load a state written by :func:`save_train_state` into ``model`` and
    ``optimizer`` (strict); returns (step, the meta dict or None)."""
    path = os.path.abspath(path)
    payload = restore_checkpoint(path)
    if set(payload) != {"params", "batch_stats", "opt_state", "step"}:
        raise KeyError("{}: not a train state (keys {})".format(
            path, sorted(payload)))
    step = int(payload["step"])
    model.load_state_dict(flax_to_state_dict(
        {"params": payload["params"], "batch_stats": payload["batch_stats"]},
        model), strict=True)
    _load_optimizer(model, optimizer, payload["opt_state"], step)
    extra = None
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            extra = json.load(f)
    return step, extra
