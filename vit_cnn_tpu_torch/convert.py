"""Flax variables <-> the port's ``state_dict``.

The port's module tree mirrors the flax tree name for name, so a flax path
``a/b/leaf`` maps to the key ``a.b.<leaf'>`` with these leaf rules (the
inverse of the torch -> flax helpers in tests/test_reference_parity.py):

  params/.../kernel  (in, out) Dense       -> weight (out, in)
                     (kh, kw, in, out) Conv -> weight (out, in, kh, kw)
                     (k, 1, d) conv1d taps  -> weight (k, d)
  params/.../scale   LayerNorm / BatchNorm  -> weight
  params/.../bias, pos_embed, A_log, D, direction_gate -> same name
  batch_stats/.../mean, var                 -> running_mean, running_var

Variables are nested dicts of numpy arrays (a flax variable tree after
``jax.device_get``). :func:`flax_to_state_dict` raises on any variable it
does not consume and on any port parameter or statistic left unset.
:func:`seeded_variables` draws seeded random values for every variable,
for tests and smoke runs that need all of them non-trivial (NonLocal's
output BN scale starts at zero, so init weights would hide it).
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch
import torch.nn as nn

from .nn.layers import ChannelLastBatchNorm, Conv, Dense, LayerNorm
from .nn.mamba import CausalDWConv

_COLLECTIONS = ("params", "batch_stats")


def _flatten(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for k in sorted(tree):
        v = tree[k]
        if hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _leaf_to_port(col: str, path, arr: np.ndarray):
    leaf = path[-1]
    if col == "batch_stats":
        names = {"mean": "running_mean", "var": "running_var"}
        if leaf not in names:
            raise KeyError("batch_stats/{}: not a BatchNorm statistic".format(
                "/".join(path)))
        return names[leaf], arr
    if leaf == "kernel":
        if arr.ndim == 2:
            return "weight", arr.T
        if arr.ndim == 4:
            return "weight", arr.transpose(3, 2, 0, 1)
        if arr.ndim == 3 and arr.shape[1] == 1:
            return "weight", arr[:, 0, :]
        raise ValueError("params/{}: kernel of shape {} fits no rule".format(
            "/".join(path), arr.shape))
    if leaf == "scale":
        return "weight", arr
    return leaf, arr


def flax_to_state_dict(variables: Dict, model: nn.Module
                       ) -> Dict[str, torch.Tensor]:
    """Map a flax variable tree onto ``model``'s state_dict keys, dtypes
    and shapes (strict in both directions)."""
    expected = model.state_dict()
    extra = set(variables) - set(_COLLECTIONS)
    if extra:
        raise KeyError("unknown variable collections: {}".format(
            sorted(extra)))
    out: Dict[str, torch.Tensor] = {}
    for col in _COLLECTIONS:
        for path, value in _flatten(variables.get(col, {})):
            name, arr = _leaf_to_port(col, path, np.asarray(value))
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


def state_dict_to_flax(model: nn.Module) -> Dict:
    """The inverse map: ``model``'s parameters and statistics as a flax
    variable tree of numpy arrays."""
    modules = dict(model.named_modules())
    tree: Dict = {"params": {}, "batch_stats": {}}
    for key, t in model.state_dict().items():
        prefix, _, name = key.rpartition(".")
        mod = modules[prefix]
        arr = t.detach().float().cpu().numpy()
        col = "params"
        if name in ("running_mean", "running_var"):
            col, name = "batch_stats", name[len("running_"):]
        elif name == "weight" and isinstance(mod, (LayerNorm,
                                                   ChannelLastBatchNorm)):
            name = "scale"
        elif name == "weight" and isinstance(mod, Dense):
            name, arr = "kernel", arr.T
        elif name == "weight" and isinstance(mod, Conv):
            name, arr = "kernel", arr.transpose(2, 3, 1, 0)
        elif name == "weight" and isinstance(mod, CausalDWConv):
            name, arr = "kernel", arr[:, None, :]
        node = tree[col]
        for part in prefix.split(".") if prefix else ():
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(arr)
    return tree


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
            elif leaf == "bias" and path[-2] == "dt_proj":
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
            else:
                raise KeyError("{}/{}: no seeded rule".format(
                    col, "/".join(path)))
            node = out.setdefault(col, {})
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[leaf] = v.astype(np.float32)
    return out
