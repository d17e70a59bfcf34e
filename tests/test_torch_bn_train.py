"""Train-mode BatchNorm's passes (ops/bn_train.py) on the CPU.

On a CPU tensor each pass runs its closed form, so the autograd Function
is exercised here end to end: forward, backward, running statistics and
the mesh's sums between the passes. Held against float64 autograd of the
chain the port runs on the CPU (``ChannelLastBatchNorm`` in train mode):

* float64, closed form against the chain: 1e-10 relative (norm), at C = 1,
  25, 49, 128, 256 and 1,024, with and without the ReLU. The closed form
  divides the sums by the count where the chain takes means, so the two
  part in the last bits only.
* float32 and bfloat16 against the float64 chain: 2e-5 and 1.6e-2
  relative (norm): a few float32 roundings of sums over the rows, and one
  bf16 rounding of each output (2^-8 relative at most, ~2^-9.4 in norm),
  with room for the bf16 roundings of the chain's own input.
* a constant channel, where the raw variance E[x^2] - E[x]^2 lies below
  0: the backward equals float64 autograd of the closed-form forward, whose
  clamp passes no gradient there.
* the running statistics equal the plain update of the pair's own batch
  statistics, bit for bit; ``updates_statistics`` False leaves them.

The kernels themselves are held to these on the card
(tests/test_torch_bn_train_cuda.py). The dispatch: the CPU and float64
keep the plain chain.
"""

from __future__ import annotations

import types

import pytest
import torch

from vit_cnn_tpu_torch.models.fusatnet import FusAtNet
from vit_cnn_tpu_torch.models.mm_mamba import MultimodalityMamba
from vit_cnn_tpu_torch.models.moco import BatchStatsNorm
from vit_cnn_tpu_torch.nn.layers import ChannelLastBatchNorm, init_parameters
from vit_cnn_tpu_torch.ops import bn_train
from vit_cnn_tpu_torch.parallel import mesh

WIDTHS = [1, 25, 49, 128, 256, 1024]
TOL = {torch.float64: 1e-10, torch.float32: 2e-5, torch.bfloat16: 1.6e-2}


def _gap(got, want):
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _case(c, seed=0, rows=(3, 4, 5)):
    """x with per-channel offsets and scales (as conv outputs have them),
    dy, and the BatchNorm's weight, bias and running statistics, in
    float64."""
    g = torch.Generator().manual_seed(seed)
    shape = rows + (c,)
    x = (torch.randn(shape, generator=g, dtype=torch.float64)
         * (0.5 + torch.rand(c, generator=g, dtype=torch.float64))
         + 2 * torch.randn(c, generator=g, dtype=torch.float64))
    dy = torch.randn(shape, generator=g, dtype=torch.float64)
    weight = 1 + 0.3 * torch.randn(c, generator=g, dtype=torch.float64)
    bias = 0.2 * torch.randn(c, generator=g, dtype=torch.float64)
    rm = 0.3 * torch.randn(c, generator=g, dtype=torch.float64)
    rv = 0.5 + torch.rand(c, generator=g, dtype=torch.float64)
    return x, dy, weight, bias, rm, rv


def _chain(x, dy, weight, bias, rm, rv, relu, cls=ChannelLastBatchNorm,
           **kw):
    """The plain chain in train mode on the CPU: (y, dx, dw, db, running
    mean, running var)."""
    bn = cls(x.shape[-1], **kw).to(x.dtype).train()
    with torch.no_grad():
        for t, v in zip((bn.weight, bn.bias, bn.running_mean,
                         bn.running_var), (weight, bias, rm, rv)):
            t.copy_(v)
    x = x.detach().clone().requires_grad_()
    y = bn(x, relu=relu)
    y.backward(dy)
    return (y.detach(), x.grad, bn.weight.grad, bn.bias.grad,
            bn.running_mean.detach(), bn.running_var.detach())


def _pair(x, dy, weight, bias, rm, rv, relu, update=True, decay=0.9):
    """The Function on CPU tensors (the passes' closed forms), the same
    six results; the running statistics float32 or float64 as the layer
    keeps them."""
    f = torch.float64 if x.dtype == torch.float64 else torch.float32
    x = x.detach().clone().requires_grad_()
    weight = weight.detach().clone().requires_grad_()
    bias = bias.detach().clone().requires_grad_()
    rm, rv = rm.to(f).clone(), rv.to(f).clone()
    y = bn_train.bn_train(x, weight, bias, rm, rv,
                          ChannelLastBatchNorm.eps, decay, relu, update)
    y.backward(dy.to(x.dtype))
    return y.detach(), x.grad, weight.grad, bias.grad, rm, rv


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("c", WIDTHS)
def test_closed_form_is_the_chain_in_float64(c, relu):
    args = _case(c)
    for got, want in zip(_pair(*args, relu), _chain(*args, relu)):
        assert got.dtype == want.dtype == torch.float64
        assert got.shape == want.shape
        assert _gap(got, want) < TOL[torch.float64]


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("c", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_low_precision_against_the_float64_chain(dtype, c, relu):
    """Inputs, parameters and cotangent rounded to ``dtype``; the float64
    chain fed the same rounded values."""
    x, dy, weight, bias, rm, rv = (t.to(dtype) for t in _case(c, seed=1))
    got = _pair(x, dy, weight, bias, rm, rv, relu)
    want = _chain(*(t.double() for t in (x, dy, weight, bias, rm, rv)),
                  relu)
    names = ("y", "dx", "dw", "db", "running mean", "running var")
    for name, a, b, like in zip(names, got, want, (x, x, weight, bias)):
        if name.startswith("running"):
            assert a.dtype == torch.float32
        else:
            assert a.dtype == like.dtype
        assert torch.isfinite(a).all()
        assert _gap(a, b) < TOL[dtype], name


def test_parameters_in_another_dtype_than_x():
    """bf16 activations with float32 parameters are refused: the passes
    take weight and bias in x's dtype (bf16_train_apply casts both)."""
    x, dy, weight, bias, rm, rv = _case(128, seed=2)
    with pytest.raises(ValueError, match="per-channel"):
        _pair(x.bfloat16(), dy.bfloat16(), weight.float(), bias.float(),
              rm, rv, True)


def _constant_channel(dtype):
    """A case whose channel 0 is one value, chosen so that the closed
    form's raw variance of that channel is below 0 in ``dtype``'s wide
    type (the clamped branch)."""
    x, dy, weight, bias, rm, rv = _case(8, seed=3)
    x = x.to(dtype)
    for v in torch.linspace(0.1, 3.0, 200, dtype=torch.float64):
        x[..., 0] = v
        raw = bn_train.statistics(bn_train.moments_reference(x))[2]
        if raw[0] < 0:
            return x, dy.to(dtype), weight.to(dtype), bias.to(dtype), rm, rv
    raise AssertionError("no constant gives a negative raw variance")


@pytest.mark.parametrize("relu", [False, True])
def test_constant_channel_takes_the_clamped_branch(relu):
    """Where the raw variance is below 0, no gradient flows through it:
    the closed-form backward equals float64 autograd of the closed-form
    forward (the clamp's own rule), and the float32 pair stays finite and
    near the float64 chain."""
    x, dy, weight, bias, rm, rv = _constant_channel(torch.float64)
    got = _pair(x, dy, weight, bias, rm, rv, relu)
    xs, ws, bs = (t.clone().requires_grad_() for t in (x, weight, bias))
    y = bn_train.apply_reference(xs, bn_train.moments_reference(xs), ws, bs,
                                 ChannelLastBatchNorm.eps, relu)
    y.backward(dy)
    for a, b in zip(got[1:4], (xs.grad, ws.grad, bs.grad)):
        assert _gap(a, b) < TOL[torch.float64]
    x32, dy32, w32, b32, rm32, rv32 = _constant_channel(torch.float32)
    got = _pair(x32, dy32, w32, b32, rm32, rv32, relu)
    want = _chain(*(t.double() for t in (x32, dy32, w32, b32, rm32, rv32)),
                  relu)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert _gap(a, b) < TOL[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_running_statistics_are_the_plain_update(dtype):
    """Bit for bit ``decay * old + (1 - decay) * batch`` on the pair's own
    batch mean and var, in float32."""
    x, dy, weight, bias, rm, rv = (t.to(dtype) for t in _case(49, seed=4))
    _, _, _, _, got_m, got_v = _pair(x, dy, weight, bias, rm, rv, True)
    mean, var, _ = bn_train.statistics(bn_train.moments_reference(x))
    assert torch.equal(got_m, 0.9 * rm.float() + (1 - 0.9) * mean)
    assert torch.equal(got_v, 0.9 * rv.float() + (1 - 0.9) * var)


def test_statistics_only_norm_leaves_the_running_statistics():
    """MoCo's BatchStatsNorm: the batch's statistics normalise, the
    running ones stay; forward and gradients are the chain's."""
    x, dy, weight, bias, rm, rv = _case(64, seed=5)
    got = _pair(x, dy, weight, bias, rm, rv, False, update=False)
    want = _chain(x, dy, weight, bias, rm, rv, False, cls=BatchStatsNorm)
    assert torch.equal(got[4], rm) and torch.equal(got[5], rv)
    assert torch.equal(want[4], rm) and torch.equal(want[5], rv)
    for a, b in zip(got[:4], want[:4]):
        assert _gap(a, b) < TOL[torch.float64]


def test_zero_scale_norm():
    """NonLocal's zero-initialised scale: y is the bias (ReLU'd), dx is 0,
    dw is not."""
    x, dy, _, bias, rm, rv = _case(32, seed=6)
    weight = torch.zeros(32, dtype=torch.float64)
    got = _pair(x, dy, weight, bias, rm, rv, True)
    want = _chain(x, dy, weight, bias, rm, rv, True, zero_scale=True)
    assert torch.equal(got[1], torch.zeros_like(x))
    assert got[2].abs().max() > 0
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[2:], want[2:]):
        assert _gap(a, b) < TOL[torch.float64]


class _TwoRanks:
    """A mesh of two ranks that hold the same rows: ``sum_`` doubles."""

    world_size = 2

    def sum_(self, t):
        return t.mul_(2)


def test_mesh_sums_between_the_passes():
    """Under a mesh the statistics and dx are the global batch's and dw, db
    this rank's: with both ranks on the same rows, y and dx equal the
    chain's on the two copies stacked, and dw, db half its."""
    x, dy, weight, bias, rm, rv = _case(25, seed=7)
    with mesh.engaged(_TwoRanks()):
        got = _pair(x, dy, weight, bias, rm, rv, True)
    both = _chain(torch.cat([x, x]), torch.cat([dy, dy]), weight, bias, rm,
                  rv, True)
    n = x.shape[0]
    want = (both[0][:n], both[1][:n], both[2] / 2, both[3] / 2, both[4],
            both[5])
    for a, b in zip(got, want):
        assert _gap(a, b) < TOL[torch.float64]


@pytest.mark.parametrize("device,dtype,engaged", [
    ("cuda", torch.bfloat16, True),
    ("cuda", torch.float32, True),
    ("cuda", torch.float64, False),
    ("cuda", torch.float16, False),
    ("cpu", torch.bfloat16, False),
    ("cpu", torch.float32, False),
])
def test_engages_on_cuda_in_float32_and_bfloat16(device, dtype, engaged):
    """x alone decides: the CPU and float64 keep the plain chain; on the
    card a tensor the passes do not take raises (below), never falls back
    to the chain."""
    x = types.SimpleNamespace(is_cuda=device == "cuda", dtype=dtype)
    assert bn_train.engages(x) == engaged


@pytest.mark.parametrize("case,refused", [
    (dict(), False),
    (dict(weight=torch.float32), True),            # bf16 x, float32 weight
    (dict(weight=torch.float32, bias=torch.float32), True),
    (dict(bias=torch.float64), True),
    (dict(stats=torch.bfloat16), True),            # updated in bf16
    (dict(stats=torch.bfloat16, update=False), False),
    (dict(width=7), True),                         # vectors of another C
    (dict(rows=0), True),                          # an empty batch
    (dict(device="meta"), True),                   # on another device
])
def test_the_passes_refuse_tensors_they_do_not_take(case, refused):
    """weight and bias in x's dtype, the updated running statistics in
    float32, all (C,) on x's device, and a non-empty x; anything else
    raises before a pass runs."""
    c, dtype = 8, torch.bfloat16
    x = torch.randn(case.get("rows", 4), c).to(dtype).requires_grad_()
    vec = case.get("width", c)
    weight = torch.ones(vec, dtype=case.get("weight", dtype),
                        device=case.get("device", "cpu"))
    bias = torch.zeros(vec, dtype=case.get("bias", weight.dtype))
    stats = [torch.zeros(c, dtype=case.get("stats", torch.float32))
             for _ in range(2)]
    before = [t.clone() for t in stats]
    run = lambda: bn_train.bn_train(  # noqa: E731
        x, weight, bias, *stats, ChannelLastBatchNorm.eps, 0.9, True,
        case.get("update", True))
    if refused:
        with pytest.raises(ValueError):
            run()
        assert all(torch.equal(a, b) for a, b in zip(stats, before))
    else:
        run().float().sum().backward()
        assert x.grad.dtype == dtype


def test_cpu_keeps_the_plain_chain(monkeypatch):
    """A train step of every BatchNorm on the CPU never reaches the
    Function, in float32 or float64."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU took the kernels' path")

    monkeypatch.setattr(bn_train, "bn_train", refuse)
    for dtype in (torch.float32, torch.float64):
        model = init_parameters(FusAtNet(6, 1, 4), 0).to(dtype).train()
        model(torch.randn(2, 11, 11, 6, dtype=dtype),
              torch.randn(2, 11, 11, 1, dtype=dtype)).sum().backward()


@pytest.fixture
def calls(monkeypatch):
    """The dispatch as if every tensor were on the card; each Function
    call's width, ReLU and whether its input wants a gradient recorded."""
    seen = []
    real = bn_train.bn_train

    def record(x, *args):
        seen.append((x.shape[-1], args[-2], x.requires_grad))
        return real(x, *args)

    monkeypatch.setattr(bn_train, "engages", lambda *a: True)
    monkeypatch.setattr(bn_train, "bn_train", record)
    return seen


@pytest.mark.parametrize("name,sites,inputs,widths", [
    ("FusAtNet", 35, 0, [128, 256, 1024]),
    ("flagship", 16, 2, [1, 16, 25, 49, 128, 144, 256]),
])
def test_every_train_mode_batch_norm_takes_the_function(calls, name, sites,
                                                        inputs, widths):
    """The train-mode sites chip_smoke.py counts (BN_SITES): FusAtNet's 35
    units with their ReLU, the flagship's 16 BatchNorms, of which the two
    of its inputs want no dx (BN_INPUTS); gradients finite."""
    if name == "FusAtNet":
        model, p, bands = FusAtNet(6, 1, 4), 11, 6
    else:
        model, p, bands = MultimodalityMamba(9, 144, 1, 32, 5), 9, 144
    model = init_parameters(model, 0).train()
    out = model(torch.randn(2, p, p, bands), torch.randn(2, p, p, 1))
    out.sum().backward()
    assert len(calls) == sites
    assert sum(not grad for _, _, grad in calls) == inputs
    assert sorted({c for c, _, _ in calls}) == widths
    if name == "FusAtNet":
        assert all(relu for _, relu, _ in calls)
    assert all(torch.isfinite(q.grad).all() for q in model.parameters()
               if q.grad is not None)
