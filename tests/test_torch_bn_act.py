"""Eval-mode BatchNorm's pass (ops/bn_act.py) on the CPU: the plain version
is the chain the port ran before it, bit for bit, in float32, bfloat16 and
float64, with and without the conv bias and the ReLU; train mode is
unchanged, forward, gradients and running statistics; and the rules of
the dispatch: the kernel only in eval mode, on CUDA, in float32 or
bfloat16, with no gradient wanted. The kernel itself is held to the plain
version on the card (tests/test_torch_bn_act_cuda.py)."""

from __future__ import annotations

import types

import pytest
import torch
import torch.nn.functional as F

from vit_cnn_tpu_torch.models.fusatnet import FusAtNet
from vit_cnn_tpu_torch.models.mm_mamba import MultimodalityMamba
from vit_cnn_tpu_torch.nn.layers import (ChannelLastBatchNorm, ConvBNReLU,
                                         init_parameters)
from vit_cnn_tpu_torch.ops import bn_act

DTYPES = [torch.float32, torch.bfloat16, torch.float64]


def _bits(t):
    """The tensor's bit patterns, so that NaN payloads and -0 compare."""
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.contiguous().view(ints[t.element_size()])


def _old_bn(bn, x, train=False):
    """ChannelLastBatchNorm.forward as the port had it before the pass
    (no mesh), statistics updated in place in train mode."""
    f = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf = x.to(f)
    if train:
        axes = tuple(range(x.dim() - 1))
        mean = xf.mean(dim=axes)
        var = ((xf * xf).mean(dim=axes) - mean * mean).clamp_min(0)
        with torch.no_grad():
            bn.running_mean.copy_(bn.decay * bn.running_mean.to(f)
                                  + (1 - bn.decay) * mean)
            bn.running_var.copy_(bn.decay * bn.running_var.to(f)
                                 + (1 - bn.decay) * var)
    else:
        mean, var = bn.running_mean.to(f), bn.running_var.to(f)
    mul = torch.rsqrt(var + bn.eps) * bn.weight.to(f)
    y = (xf - mean) * mul + bn.bias.to(f)
    return y.to(x.dtype)


def _bn(c, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    bn = ChannelLastBatchNorm(c)
    with torch.no_grad():
        bn.weight.normal_(generator=g)
        bn.bias.normal_(generator=g)
        bn.running_mean.normal_(generator=g)
        bn.running_var.uniform_(0.05, 3.0, generator=g)
    return bn.to(dtype)


def _input(shape, dtype, seed=1):
    g = torch.Generator().manual_seed(seed)
    x = (3 * torch.randn(shape, generator=g)).to(dtype)
    flat = x.view(-1)
    flat[:4] = torch.tensor([float("nan"), float("inf"), -float("inf"),
                             -0.0]).to(dtype)
    return x


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_version_is_the_old_chain(dtype, with_bias, relu):
    c = 13
    bn = _bn(c, dtype).eval()
    x = _input((4, 3, 5, c), dtype)
    cb = (torch.randn(c, generator=torch.Generator().manual_seed(2))
          .to(dtype) if with_bias else None)
    want = _old_bn(bn, x if cb is None else x + cb)
    want = F.relu(want) if relu else want
    got = bn(x, cb, relu)
    plain = bn_act.bn_act_reference(x, bn.running_mean, bn.running_var,
                                    bn.weight, bn.bias, bn.eps, cb, relu)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(plain), _bits(want))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_conv_bn_relu_is_the_old_chain(dtype, train):
    """ConvBNReLU (the CPU keeps the conv's bias in the conv), forward,
    gradients and running statistics."""
    unit = init_parameters(ConvBNReLU(5, 8), 3).to(dtype)
    with torch.no_grad():
        unit.Conv_0.bias.normal_(generator=torch.Generator().manual_seed(4))
    old = init_parameters(ConvBNReLU(5, 8), 3).to(dtype)
    old.load_state_dict(unit.state_dict())
    unit.train(train)
    old.train(train)
    x = torch.randn((3, 6, 6, 5), generator=torch.Generator().manual_seed(5))
    xs = [x.to(dtype).requires_grad_() for _ in range(2)]
    got = unit(xs[0])
    conv = old.Conv_0
    want = F.relu(_old_bn(old.BatchNorm_0.bn, F.conv2d(
        xs[1].movedim(-1, 1), conv.weight, conv.bias, 1, 1).movedim(1, -1),
        train=train))
    assert torch.equal(_bits(got), _bits(want))
    g = torch.randn(got.shape, generator=torch.Generator().manual_seed(6))
    got.backward(g.to(dtype))
    want.backward(g.to(dtype))
    assert torch.equal(_bits(xs[0].grad), _bits(xs[1].grad))
    for (name, a), b in zip(unit.named_parameters(), old.parameters()):
        assert torch.equal(_bits(a.grad), _bits(b.grad)), name
    for a, b in zip(unit.buffers(), old.buffers()):
        assert torch.equal(_bits(a), _bits(b))


def _stub(device="cuda", dtype=torch.bfloat16, grad=False):
    return types.SimpleNamespace(is_cuda=device == "cuda", dtype=dtype,
                                 device=torch.device(device, 0),
                                 requires_grad=grad)


@pytest.mark.parametrize("case,grad_mode,engaged", [
    (dict(), False, True),
    (dict(dtype=torch.float32), False, True),
    (dict(dtype=torch.float64), False, False),
    (dict(dtype=torch.float16), False, False),
    (dict(device="cpu"), False, False),
    (dict(), True, True),                          # nothing requires grad
    (dict(grad=True), True, False),                # a leaf requires grad
    (dict(grad=True), False, True),                # grad mode off
    (dict(vector_dtype=torch.float64), False, False),
    (dict(vector_dtype=torch.float32), False, False),  # mixed dtypes
    (dict(vector_device="cpu"), False, False),
])
def test_engages_only_without_gradients_on_cuda(case, grad_mode, engaged):
    case = dict(case)
    dtype = case.get("dtype", torch.bfloat16)
    vector = _stub(case.pop("vector_device", "cuda"),
                   case.pop("vector_dtype", dtype))
    grad = case.pop("grad", False)
    x = _stub(**case)
    weight = _stub(dtype=dtype, grad=grad)
    with torch.set_grad_enabled(grad_mode):
        assert bn_act.engages(x, vector, vector, weight, None) == engaged


class _NoKernel:
    """Stands in for the kernel: calls it only records."""

    def __init__(self):
        self.calls = []

    def __call__(self, x, mean, var, weight, bias, eps, conv_bias, relu):
        self.calls.append((x.shape[-1], conv_bias is not None, relu))
        return bn_act.bn_act_reference(x, mean, var, weight, bias, eps,
                                       conv_bias, relu)


@pytest.fixture
def no_kernel(monkeypatch):
    """The dispatch as if every call were on the card, the kernel's
    calls recorded."""
    kernel = _NoKernel()
    monkeypatch.setattr(bn_act, "engages", lambda x, *t: (
        not torch.is_grad_enabled() or not any(
            v is not None and v.requires_grad for v in (x, *t))))
    monkeypatch.setattr(bn_act, "_kernel", kernel)
    return kernel


def test_cpu_keeps_the_plain_chain(monkeypatch):
    monkeypatch.setattr(bn_act, "_kernel", None)   # a call would raise
    bn = _bn(6, torch.float32).eval()
    with torch.no_grad():
        bn(torch.randn(2, 6), relu=True)
    assert not bn_act.engages(torch.randn(2, 6))


def test_train_mode_and_autograd_keep_the_plain_chain(no_kernel):
    unit = init_parameters(ConvBNReLU(3, 4), 0)
    x = torch.randn(2, 5, 5, 3)
    unit(x).sum().backward()                       # train mode
    unit.eval()
    unit(x).sum().backward()                       # eval, grad wanted
    assert no_kernel.calls == []
    with torch.no_grad():
        unit(x)
    assert no_kernel.calls == [(4, True, True)]


def test_fusatnet_units_take_bias_and_relu_into_the_pass(no_kernel):
    """All 35 ConvBNReLU units of FusAtNet, each with its conv bias and
    its ReLU (the card test counts the same 35 launches)."""
    model = init_parameters(FusAtNet(6, 1, 4), 0).eval()
    with torch.inference_mode():
        model(torch.randn(2, 11, 11, 6), torch.randn(2, 11, 11, 1))
    assert len(no_kernel.calls) == 35
    assert all(bias and relu for _, bias, relu in no_kernel.calls)
    assert sorted({c for c, _, _ in no_kernel.calls}) == [128, 256, 1024]


def test_flagship_batch_norms_take_the_pass(no_kernel):
    """The flagship's 16 eval-mode BatchNorms: the ReLU taken in where it
    follows the BN directly (TokenLearner, FusionBlock, GLFusionBlock),
    none with a conv bias (their convs are 1x1: cuBLAS adds it)."""
    model = init_parameters(MultimodalityMamba(9, 144, 1, 32, 5), 0).eval()
    with torch.inference_mode():
        model(torch.randn(2, 9, 9, 144), torch.randn(2, 9, 9, 1))
    assert len(no_kernel.calls) == 16
    assert not any(bias for _, bias, _ in no_kernel.calls)
    assert sum(relu for _, _, relu in no_kernel.calls) == 10
    assert sorted({c for c, _, _ in no_kernel.calls}) == [
        1, 16, 25, 49, 128, 144, 256]
