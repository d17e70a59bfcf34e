"""Train-mode BatchNorm over the last axis, with the ReLU after it, as four
hand-written passes under one autograd Function.

* The closed forms (:func:`moments_reference`, :func:`statistics`,
  :func:`apply_reference`, :func:`backward_sums_reference`,
  :func:`backward_apply_reference`): the arithmetic of the train-mode
  chain of :class:`..nn.layers.ChannelLastBatchNorm` and of autograd
  through it, written out pass by pass in plain PyTorch, in float32
  (float64 for float64 x). They are what each pass computes on a CPU
  tensor; the tests hold them against float64 autograd of the chain.
* :func:`bn_train` — the Function (``csrc/bn_train.cu`` on the card)
  where :func:`engages`. The kernels replace no TPU kernel (the JAX
  package leaves the chain to XLA); they move 16 bytes an element of a
  bf16 tensor forward and backward together, where the chain's kernels
  move ~155.

What the passes compute is the chain's: flax's float32 statistics with
the fast biased variance ``max(E[x^2] - E[x]^2, 0)``, normalised as
``normalize`` does, the running statistics updated as ``decay * old +
(1 - decay) * batch`` (not where ``update`` is False: MoCo's
``BatchStatsNorm``), and the clamp's gradient kept: where the raw
variance is below 0 no gradient flows through it. Under an engaged mesh
(:mod:`..parallel.mesh`) the forward sums (sum x, sum x^2, count) and the
backward sums (sum g, sum g (x - mean)) are summed over the ranks between
the passes, so the statistics and dx are the global batch's and dw, db
this rank's, as the chain's ``global_sum`` gives them.
"""

from __future__ import annotations

import torch

from . import _build
from .bn_act import normalize
from ..parallel import mesh


def engages(x) -> bool:
    """Whether a train-mode BatchNorm of x takes the passes: x on CUDA in
    float32 or bfloat16. The CPU and float64 keep the plain chain."""
    return x.is_cuda and x.dtype in _build.DTYPE_CODES


def _check(x, weight, bias, running):
    """Raise unless the passes take these tensors: a non-empty x, weight
    and bias of shape (C,) in x's dtype, and the running statistics (where
    they are updated) of shape (C,) in x's wide type, all on x's device."""
    if x.numel() == 0:
        raise ValueError("train-mode BatchNorm of an empty batch {}".format(
            tuple(x.shape)))
    c = x.shape[-1]
    wants = [(t, x.dtype) for t in (weight, bias)] + [
        (t, _build.wide(x)) for t in running or ()]
    for t, dtype in wants:
        if t.shape != (c,) or t.dtype != dtype or t.device != x.device:
            raise ValueError(
                "train-mode BatchNorm of {} {} on {}: a per-channel tensor "
                "is {} {} on {}, not ({},) {}".format(
                    tuple(x.shape), x.dtype, x.device, tuple(t.shape),
                    t.dtype, t.device, c, dtype))


# -- the closed forms ------------------------------------------------------

def _rows(x):
    return x.reshape(-1, x.shape[-1]).to(_build.wide(x))


def moments_reference(x):
    """(2C + 1,): sum(x) and sum(x^2) over every axis but the last, in
    float32 (float64 for float64 x), then the row count."""
    xf = _rows(x)
    count = torch.full((1,), float(xf.shape[0]), dtype=xf.dtype,
                       device=x.device)
    return torch.cat([xf.sum(0), (xf * xf).sum(0), count])


def statistics(sums):
    """(mean, var, raw) of each channel from :func:`moments_reference`'s
    sums, as the chain's mesh branch takes them: raw = E[x^2] - E[x]^2,
    var = raw clamped at 0."""
    c = (sums.shape[0] - 1) // 2
    mean = sums[:c] / sums[-1]
    raw = sums[c:2 * c] / sums[-1] - mean * mean
    return mean, raw.clamp_min(0), raw


def apply_reference(x, sums, weight, bias, eps: float, relu: bool):
    """The normalised batch (the forward's output)."""
    mean, var, _ = statistics(sums)
    return normalize(x.to(sums.dtype), mean, var, weight, bias, eps, x.dtype,
                     relu)


def _cotangent(dy, x, sums, weight, bias, eps, relu):
    """g (dy where the recomputed output is not <= 0, all of dy without
    the ReLU) and x - mean, in the sums' dtype."""
    mean = statistics(sums)[0]
    f = sums.dtype
    g = dy.to(f)
    if relu:
        y = apply_reference(x, sums, weight, bias, eps, False)
        g = torch.where(y <= 0, torch.zeros_like(g), g)
    return g.reshape(-1, x.shape[-1]), _rows(x) - mean


def backward_sums_reference(dy, x, sums, weight, bias, eps: float,
                            relu: bool):
    """((2C,) sum g and sum g (x - mean), dw, db): dw = rsqrt(var + eps) *
    sum g (x - mean) and db = sum g, in the parameters' dtypes."""
    g, d = _cotangent(dy, x, sums, weight, bias, eps, relu)
    gsums = torch.cat([g.sum(0), (g * d).sum(0)])
    c = x.shape[-1]
    inv = torch.rsqrt(statistics(sums)[1] + eps)
    return (gsums, (inv * gsums[c:]).to(weight.dtype),
            gsums[:c].to(bias.dtype, copy=True))


def backward_apply_reference(dy, x, sums, gsums, weight, bias, eps: float,
                             relu: bool):
    """dx = a (g - sum g / n - (x - mean) c2), a = rsqrt(var + eps) w,
    c2 = rsqrt(var + eps)^2 sum g (x - mean) / n where the raw variance is
    >= 0 and 0 where it is not (the clamp passes no gradient there)."""
    g, d = _cotangent(dy, x, sums, weight, bias, eps, relu)
    _, var, raw = statistics(sums)
    c = x.shape[-1]
    n = sums[-1]
    inv = torch.rsqrt(var + eps)
    c2 = torch.where(raw >= 0, inv * inv * gsums[c:] / n,
                     torch.zeros_like(raw))
    dx = inv * weight.to(sums.dtype) * (g - gsums[:c] / n - d * c2)
    return dx.reshape(x.shape).to(x.dtype)


# -- the passes: the kernels on CUDA, the closed forms on the CPU ----------

def moments(x):
    """Pass 1 of a contiguous x."""
    if _build.use_plain(x):
        return moments_reference(x)
    c = x.shape[-1]
    rows = x.numel() // c
    sums = torch.empty(2 * c + 1, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        work = _build.workspace("vct_bn_train", rows, c, device=x.device)
        code = _build.lib().vct_bn_train_moments(
            _build.dtype_code(x), x.data_ptr(), rows, c, work.data_ptr(),
            sums.data_ptr(), _build.stream_of(x))
    _build.check("bn_train moments", code)
    _build.launches["bn_train"] += 1
    return sums


def apply(x, sums, weight, bias, eps: float, relu: bool, running=None,
          decay: float = 0.9):
    """Pass 2: the output; ``running`` (mean, var) become ``decay * old +
    (1 - decay) * batch`` where given."""
    if _build.use_plain(x):
        if running is not None:
            mean, var, _ = statistics(sums)
            f = sums.dtype
            with torch.no_grad():
                for old, new in zip(running, (mean, var)):
                    old.copy_(decay * old.to(f) + (1 - decay) * new)
        return apply_reference(x, sums, weight, bias, eps, relu)
    c = x.shape[-1]
    y = torch.empty_like(x)
    weight, bias = weight.contiguous(), bias.contiguous()
    rm, rv = (None, None) if running is None else (
        running[0].data_ptr(), running[1].data_ptr())
    with torch.cuda.device(x.device):
        code = _build.lib().vct_bn_train_apply(
            _build.dtype_code(x), x.data_ptr(), y.data_ptr(), x.numel() // c,
            c, sums.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            float(eps), int(relu), rm, rv, float(decay), float(1 - decay),
            _build.stream_of(x))
    _build.check("bn_train apply", code)
    _build.launches["bn_train"] += 1
    return y


def backward_sums(dy, x, sums, weight, bias, eps: float, relu: bool):
    """Pass 3 of contiguous dy and x: (gsums, dw, db)."""
    if _build.use_plain(x):
        return backward_sums_reference(dy, x, sums, weight, bias, eps, relu)
    c = x.shape[-1]
    rows = x.numel() // c
    gsums = torch.empty(2 * c, dtype=torch.float32, device=x.device)
    dw = torch.empty(c, dtype=weight.dtype, device=x.device)
    db = torch.empty(c, dtype=bias.dtype, device=x.device)
    weight, bias = weight.contiguous(), bias.contiguous()
    with torch.cuda.device(x.device):
        work = _build.workspace("vct_bn_train", rows, c, device=x.device)
        code = _build.lib().vct_bn_train_backward_sums(
            _build.dtype_code(x), dy.data_ptr(), x.data_ptr(), rows, c,
            sums.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            float(eps), int(relu), work.data_ptr(), gsums.data_ptr(),
            dw.data_ptr(), db.data_ptr(), _build.stream_of(x))
    _build.check("bn_train backward sums", code)
    _build.launches["bn_train"] += 1
    return gsums, dw, db


def backward_apply(dy, x, sums, gsums, weight, bias, eps: float, relu: bool):
    """Pass 4 of contiguous dy and x: dx."""
    if _build.use_plain(x):
        return backward_apply_reference(dy, x, sums, gsums, weight, bias, eps,
                                        relu)
    c = x.shape[-1]
    dx = torch.empty_like(x)
    weight, bias = weight.contiguous(), bias.contiguous()
    with torch.cuda.device(x.device):
        code = _build.lib().vct_bn_train_backward_apply(
            _build.dtype_code(x), dy.data_ptr(), x.data_ptr(), dx.data_ptr(),
            x.numel() // c, c, sums.data_ptr(), gsums.data_ptr(),
            weight.data_ptr(), bias.data_ptr(), float(eps), int(relu),
            _build.stream_of(x))
    _build.check("bn_train backward apply", code)
    _build.launches["bn_train"] += 1
    return dx


class _BNTrain(torch.autograd.Function):
    """Passes 1-2 forward, 3-4 backward (x saved, the output recomputed
    for the ReLU's mask), the mesh's sums between them."""

    @staticmethod
    def forward(ctx, x, weight, bias, running, eps, decay, relu):
        x = x.contiguous()
        ranks = mesh.current()
        sums = moments(x)
        if ranks is not None:
            ranks.sum_(sums)
        y = apply(x, sums, weight, bias, eps, relu, running, decay)
        ctx.save_for_backward(x, weight, bias, sums)
        ctx.eps, ctx.relu, ctx.ranks = eps, relu, ranks
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, weight, bias, sums = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        gsums, dw, db = backward_sums(dy, x, sums, weight, bias, ctx.eps,
                                      ctx.relu)
        if ctx.ranks is not None:
            ctx.ranks.sum_(gsums)       # dw, db stay this rank's
        dx = None
        if ctx.needs_input_grad[0]:
            dx = backward_apply(dy, x, sums, gsums, weight, bias, ctx.eps,
                                ctx.relu)
        return dx, dw, db, None, None, None, None


def bn_train(x, weight, bias, running_mean, running_var, eps: float,
             decay: float, relu: bool = False, update: bool = True):
    """Train-mode BatchNorm of x (..., C) over every axis but the last,
    before a ReLU where asked, the running statistics updated in place
    where ``update``: the passes on x's device (the kernels on CUDA, the
    closed forms on the CPU). The caller checks :func:`engages`; tensors
    the passes do not take raise (:func:`_check`). The statistics are no
    inputs of the autograd graph: they are written in place, as the chain
    writes them under ``no_grad``."""
    running = (running_mean, running_var) if update else None
    _check(x, weight, bias, running)
    return _BNTrain.apply(x, weight, bias, running, eps, decay, relu)
