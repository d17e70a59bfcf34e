"""Flax variables <-> the port's ``state_dict``.

The port's module tree mirrors the flax tree name for name, so a flax path
``a/b/leaf`` maps to the key ``a.b.<leaf'>``. The rule for a leaf is
picked by the port module that owns it (the module at ``a.b``), never by
the array's shape; a ``kernel`` goes by the module's ``flax_kernel``:

  params/.../kernel  "dense" (in, out)                 -> weight (out, in)
                             (the Mamba layer's per-sample ``gate`` too)
                     "conv"  (*k, in / groups, out)     -> weight
                             (out, in / groups, *k), 1-D to 3-D kernels
                     "taps"  (k, 1, d) depthwise taps   -> weight (k, d)
  params/.../scale   LayerNorm / BatchNorm (``ln2``)   -> weight
  params/.../<other> bias, pos_embed, A_log, cls_token, skipcat0,
                     token_wA, dim_reduce, ...          -> same name, shape
  batch_stats/.../mean, var                 -> running_mean, running_var

Variables are nested dicts of numpy arrays (a flax variable tree after
``jax.device_get``). :func:`flax_to_state_dict` raises on any variable it
does not consume and on any port parameter or statistic left unset.
:func:`seeded_variables` draws seeded random values for every variable,
for tests and smoke runs that need all of them non-trivial (NonLocal's
output BN scale starts at zero, so init weights would hide it);
:func:`seeded_state_dict` gives the same values as a port state_dict.
:func:`moco_state_to_flax` / :func:`flax_to_moco_state` carry a MoCo
pretraining state (``vit_cnn_tpu.models.moco.MoCoState`` as
``flax.serialization.to_state_dict`` gives it: ``key_variables``,
``queue``, ``queue_ptr``) across.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from .nn.layers import ChannelLastBatchNorm, LayerNorm

_COLLECTIONS = ("params", "batch_stats")
#: kernel layouts: flax array -> port weight, port weight -> flax array
_KERNELS = {
    "dense": (lambda a: a.T, lambda w: w.T),
    "conv": (lambda a: a.transpose(a.ndim - 1, a.ndim - 2,
                                   *range(a.ndim - 2)),
             lambda w: w.transpose(*range(2, w.ndim), 1, 0)),
    "taps": (lambda a: a[:, 0, :], lambda w: w[:, None, :]),
}
_NORMS = (LayerNorm, ChannelLastBatchNorm)


def _flatten(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for k in sorted(tree):
        v = tree[k]
        if hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _leaf_to_port(col: str, path, arr: np.ndarray, mod: nn.Module):
    leaf = path[-1]
    where = "{}/{}".format(col, "/".join(path))
    if col == "batch_stats":
        names = {"mean": "running_mean", "var": "running_var"}
        if leaf not in names:
            raise KeyError("{}: not a BatchNorm statistic".format(where))
        return names[leaf], arr
    if leaf == "kernel":
        layout = getattr(mod, "flax_kernel", None)
        if layout not in _KERNELS:
            raise KeyError("{}: the port module {} takes no kernel".format(
                where, type(mod).__name__))
        return "weight", _KERNELS[layout][0](arr)
    if leaf == "scale" and isinstance(mod, _NORMS):
        return "weight", arr
    return leaf, arr


def flax_to_state_dict(variables: Dict, model: nn.Module,
                       expected: Optional[Dict[str, torch.Tensor]] = None
                       ) -> Dict[str, torch.Tensor]:
    """Map a flax variable tree onto ``model``'s state_dict keys, dtypes
    and shapes (strict in both directions). ``expected`` names the entries
    to fill, with their dtypes and shapes: ``model.state_dict()`` by
    default, or a part of it (the parameters, for optimizer moments)."""
    expected = model.state_dict() if expected is None else expected
    modules = dict(model.named_modules())
    extra = set(variables) - set(_COLLECTIONS)
    if extra:
        raise KeyError("unknown variable collections: {}".format(
            sorted(extra)))
    out: Dict[str, torch.Tensor] = {}
    for col in _COLLECTIONS:
        for path, value in _flatten(variables.get(col, {})):
            owner = ".".join(path[:-1])
            if owner not in modules:
                raise KeyError("{}/{}: the port has no module {!r}".format(
                    col, "/".join(path), owner))
            name, arr = _leaf_to_port(col, path, np.asarray(value),
                                      modules[owner])
            key = ".".join(path[:-1] + (name,))
            if key not in expected:
                raise KeyError("{}/{} -> {}: the port has no such entry"
                               .format(col, "/".join(path), key))
            if tuple(arr.shape) != tuple(expected[key].shape):
                raise ValueError("{}: shape {} != port {}".format(
                    key, arr.shape, tuple(expected[key].shape)))
            out[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(
                expected[key].dtype)
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError("port entries left unset: {}".format(missing))
    return out


def state_dict_to_flax(model: nn.Module,
                       state: Optional[Dict[str, torch.Tensor]] = None
                       ) -> Dict:
    """The inverse map: ``model``'s parameters and statistics as a flax
    variable tree of numpy arrays. ``state`` gives the values under
    ``model``'s state_dict keys (default: ``model.state_dict()``; a host
    copy of it, or the optimizer's moments of the parameters)."""
    modules = dict(model.named_modules())
    tree: Dict = {"params": {}, "batch_stats": {}}
    state = model.state_dict() if state is None else state
    for key, t in state.items():
        prefix, _, name = key.rpartition(".")
        mod = modules[prefix]
        arr = t.detach().cpu()
        arr = (arr.float() if arr.dtype == torch.bfloat16 else arr).numpy()
        col = "params"
        layout = getattr(mod, "flax_kernel", None)
        if name in ("running_mean", "running_var"):
            col, name = "batch_stats", name[len("running_"):]
        elif name == "weight" and isinstance(mod, _NORMS):
            name = "scale"
        elif name == "weight" and layout in _KERNELS:
            name, arr = "kernel", _KERNELS[layout][1](arr)
        node = tree[col]
        for part in prefix.split(".") if prefix else ():
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(arr)
    return tree


def moco_state_to_flax(encoder: nn.Module, moco) -> Dict:
    """A port ``MoCoState`` (models/moco.py) of ``encoder`` as the JAX
    MoCoState's state dict of numpy arrays."""
    return {"key_variables": state_dict_to_flax(encoder, moco.key_variables),
            "queue": moco.queue.detach().cpu().numpy(),
            "queue_ptr": np.asarray(moco.queue_ptr, np.int32)}


def flax_to_moco_state(tree: Dict, encoder: nn.Module, device="cpu"):
    """The JAX MoCoState's state dict as a port ``MoCoState`` of
    ``encoder`` on ``device`` (the key variables strict both ways)."""
    from .models.moco import MoCoState

    key = flax_to_state_dict(tree["key_variables"], encoder)
    return MoCoState({k: v.to(device) for k, v in key.items()},
                     torch.tensor(np.asarray(tree["queue"], np.float32),
                                  device=device),
                     int(tree["queue_ptr"]))


#: learned tokens and positions of the transformer zoo, MFT and HCTnet
_TOKEN_LEAVES = ("cls_token", "pos_embedding", "encoder_pos_embed",
                 "decoder_pos_embed", "position_embeddings")
#: matrices contracted over their last axis: MFT's and HCTnet's token
#: pooling (token_wA, token_wV, ...), S2ENet's affinity reductions
_MIXING_LEAVES = ("token_wA", "token_wV", "token_wA_L", "token_wV_L",
                  "dim_reduce")
#: learned mixing scalars of MHST and GLT_Net (shape (1,))
_SCALAR_LEAVES = ("weight_hsi", "weight_lidar", "vit_cls_coefficient",
                  "cnn_cls_coefficient", "xishu1", "xishu2", "coefficient1",
                  "coefficient2")


def seeded_variables(variables: Dict, seed: int) -> Dict:
    """A copy of a flax variable tree with every leaf drawn from
    ``np.random.RandomState(seed)`` (in sorted path order), at scales that
    keep the network's activations O(1)."""
    rng = np.random.RandomState(seed)
    out: Dict = {}
    for col in _COLLECTIONS:
        for path, value in _flatten(variables.get(col, {})):
            shape = np.shape(value)
            leaf = path[-1]
            if col == "batch_stats":
                v = (0.1 * rng.randn(*shape) if leaf == "mean"
                     else 1.0 + 0.3 * rng.rand(*shape))
            elif leaf == "kernel":
                v = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
            elif leaf == "scale":
                v = 1.0 + 0.2 * rng.randn(*shape)
            elif leaf == "bias" and path[-2:-1] == ("dt_proj",):
                dt = np.exp(rng.rand(*shape) * (np.log(0.1) - np.log(1e-3))
                            + np.log(1e-3))
                v = dt + np.log(-np.expm1(-dt))
            elif leaf == "bias":
                v = 0.1 * rng.randn(*shape)
            elif leaf == "A_log":
                v = (np.log(np.arange(1, shape[1] + 1))[None]
                     + 0.1 * rng.randn(*shape))
            elif leaf == "D":
                v = 1.0 + 0.1 * rng.randn(*shape)
            elif leaf == "direction_gate":
                v = 0.5 * rng.randn(*shape)
            elif leaf == "pos_embed":
                v = 0.02 * rng.randn(*shape)
            elif leaf in _TOKEN_LEAVES:
                v = 0.5 * rng.randn(*shape)
            elif leaf in _MIXING_LEAVES:
                v = rng.randn(*shape) / np.sqrt(shape[-1])
            elif leaf in _SCALAR_LEAVES:
                v = 0.5 + 0.1 * rng.randn(*shape)
            elif leaf.startswith("skipcat") and leaf.endswith("_bias"):
                v = 0.1 * rng.randn(*shape)
            elif leaf.startswith("skipcat"):
                v = rng.randn(*shape) / np.sqrt(shape[-1])
            else:
                raise KeyError("{}/{}: no seeded rule".format(
                    col, "/".join(path)))
            node = out.setdefault(col, {})
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[leaf] = v.astype(np.float32)
    return out


def seeded_state_dict(model: nn.Module, seed: int
                      ) -> Dict[str, torch.Tensor]:
    """``model``'s state_dict with every entry drawn by
    :func:`seeded_variables`: the same weights as the flax model given
    ``seeded_variables(..., seed)``."""
    return flax_to_state_dict(
        seeded_variables(state_dict_to_flax(model), seed), model)
