"""The port's random draws inside a forward: dropout masks, the Gumbel
uniforms of MHST's head selection and the token permutations of the
Mamba layer's shuffle streams.

Every draw goes through :func:`uniform` or :func:`permutation`, which
take their numbers from the source :func:`drawing` made current: a
``torch.Generator`` on the device of the draw (the Trainer's), or a
:class:`Recorder` / :class:`Replay`, which let two runs (the card and the
CPU, the port and the JAX package) share one set of draws. A uniform
drawn outside ``drawing`` raises: the zoo never draws from a global
generator. A permutation drawn outside ``drawing`` comes from a fixed
seed of its own (:data:`FALLBACK_SEED`), as the JAX layer falls back to
``PRNGKey(0)`` when no 'shuffle' stream is given: the same permutation on
every such call, though not the one JAX draws (no threefry here).

Under an engaged mesh (:mod:`..parallel.mesh`) the source is replicated:
every rank draws the same numbers. A uniform is batch-leading (the
Gumbel noise of MHST, every dropout mask) and is drawn at the global
batch, each rank keeping its rows; a permutation is drawn whole on every
rank (one order for the whole batch). A future uniform whose first axis
is not the batch has to say so and draw otherwise.

:class:`Dropout` is flax's ``nn.Dropout``: keep ~ Bernoulli(1 - rate)
(a uniform below 1 - rate), then ``x / (1 - rate)`` where kept and 0
elsewhere; the identity in eval mode or at rate 0, zeros at rate 1. It
draws nothing where flax draws nothing.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, List, Sequence, Union

import torch
import torch.nn as nn

from ..parallel import mesh

Source = Union[torch.Generator, Callable]
#: the seed of a permutation drawn outside ``drawing``
FALLBACK_SEED = 0
# the current source, per thread and task
_source: contextvars.ContextVar = contextvars.ContextVar("noise_source",
                                                        default=None)


@contextlib.contextmanager
def drawing(source: Source):
    """Make ``source`` the source of :func:`uniform` inside the block."""
    token = _source.set(source)
    try:
        yield source
    finally:
        _source.reset(token)


def affine(u: torch.Tensor, low: float, high: float) -> torch.Tensor:
    """[0, 1) -> [low, high), as ``jax.random.uniform`` maps its floats
    (floored at ``low``)."""
    if low == 0.0 and high == 1.0:
        return u
    return (u * (high - low) + low).clamp_min(low)


def uniform(shape: Sequence[int], device, low: float = 0.0,
            high: float = 1.0) -> torch.Tensor:
    """float32 uniforms in [low, high) of ``shape`` on ``device`` from the
    current source. ``shape`` leads with the batch: under an engaged mesh
    the draw is made at the global batch, (n*b, ...), and this rank's rows
    are returned, the world-size-1 draw's rows bit for bit."""
    source = _source.get()
    if source is None:
        raise RuntimeError("a train-mode draw of the zoo (dropout or Gumbel "
                           "noise) outside noise.drawing(generator)")
    shape = tuple(shape)
    full = (shape[0] * mesh.world_size(),) + shape[1:]
    if isinstance(source, torch.Generator):
        u = affine(torch.rand(full, generator=source, device=device), low,
                   high)
    else:
        u = source(full, device, low, high)
    return mesh.shard_rows(u)


def permutation(n: int, device) -> torch.Tensor:
    """A random permutation of ``range(n)`` (int64) on ``device`` from the
    current source, or from :data:`FALLBACK_SEED` outside ``drawing``."""
    source = _source.get()
    if source is None:
        g = torch.Generator().manual_seed(FALLBACK_SEED)
        return torch.randperm(n, generator=g).to(device)
    if isinstance(source, torch.Generator):
        return torch.randperm(n, generator=source,
                              device=source.device).to(device)
    return source.permutation(n, device)


class Recorder:
    """A source that draws from ``generator`` and keeps a CPU copy of
    every draw, in order (``draws``): float32 uniforms and int64
    permutations."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.draws: List[torch.Tensor] = []

    def __call__(self, shape, device, low, high):
        u = affine(torch.rand(shape, generator=self.generator,
                               device=self.generator.device), low, high)
        self.draws.append(u.cpu())
        return u.to(device)

    def permutation(self, n, device):
        p = torch.randperm(n, generator=self.generator,
                           device=self.generator.device)
        self.draws.append(p.cpu())
        return p.to(device)


class Replay:
    """A source that hands out ``draws`` in order, each on the device of
    the draw; a draw of another kind (a uniform where a permutation was
    recorded, or the reverse) or shape, or one too many, raises."""

    def __init__(self, draws: Sequence[torch.Tensor]):
        self.draws = list(draws)
        self.taken = 0

    def _take(self, shape, floating):
        if self.taken == len(self.draws):
            raise RuntimeError("replay: draw {} asked of {} recorded".format(
                self.taken + 1, len(self.draws)))
        u = self.draws[self.taken]
        if (tuple(u.shape) != tuple(shape)
                or u.is_floating_point() != floating):
            kinds = ("a permutation", "a uniform")
            raise RuntimeError("replay: draw {} is {} of shape {}, asked {} "
                               "of shape {}".format(
                                   self.taken, kinds[u.is_floating_point()],
                                   tuple(u.shape), kinds[floating],
                                   tuple(shape)))
        self.taken += 1
        return u

    def __call__(self, shape, device, low, high):
        return self._take(shape, True).to(device)

    def permutation(self, n, device):
        return self._take((n,), False).to(device=device, dtype=torch.int64)


def dropout(x: torch.Tensor, rate: float, training: bool) -> torch.Tensor:
    """flax ``nn.Dropout(rate)(x, deterministic=not training)``."""
    if not training or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = uniform(x.shape, x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class Dropout(nn.Module):
    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x):
        return dropout(x, self.rate, self.training)

    def extra_repr(self):
        return "rate={}".format(self.rate)
