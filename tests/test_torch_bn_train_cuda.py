"""Train-mode BatchNorm's four passes (``csrc/bn_train.cu``) on the card.

* The apply pass's y equals ``normalize`` fed the pair's own mean and var
  bit for bit (NaN and -0 handling included, through the ReLU), and the
  running statistics equal torch's ``0.9 * old + 0.1 * batch`` on them,
  at FusAtNet's shapes (123,904 x 128 / 256 / 1,024 rows x channels,
  25,600 x 256, 4,096 x 1,024, 1,024 x 1,024) and the flagship's widths
  (1, 16, 25, 49, 128, 144, 256), in float32 and bfloat16.
* The moments (sum x, sum x^2) lie within 2e-6 of float64, relative to
  the sum of |x| and of x^2.
* dx, dw and db lie no further from float64 autograd of the chain than
  the chain's own autograd in the same dtype does, with 2% of room for
  the output's own rounding (both round to the dtype last) and a floor
  of 2^-21 (eight float32 ulps, relative, in norm), at the same shapes.
* Strided, transposed and misaligned inputs and cotangents (the
  one-value path); two runs agree bit for bit; one FusAtNet bf16 train
  step launches the passes 4 times a BatchNorm (35 units: 140).

These tests need a CUDA card and skip without one. On the GPU host:

    python -m pytest --noconftest tests/test_torch_bn_train_cuda.py -q
"""

import pytest
import torch
import torch.nn.functional as F

from vit_cnn_tpu_torch.models.fusatnet import FusAtNet
from vit_cnn_tpu_torch.nn.layers import ChannelLastBatchNorm, init_parameters
from vit_cnn_tpu_torch.nn.precision import bf16_train_apply
from vit_cnn_tpu_torch.ops import _build, bn_act, bn_train

pytestmark = pytest.mark.cuda
DTYPES = [torch.float32, torch.bfloat16]
EPS = ChannelLastBatchNorm.eps
# (rows, C): FusAtNet's train-mode BatchNorms at batch 1,024, then the
# flagship's widths at 1,024 windows of 9 x 9
FUSATNET = [(123904, 128), (123904, 256), (123904, 1024), (25600, 256),
            (4096, 1024), (1024, 1024)]
FLAGSHIP = [(82944, c) for c in (1, 16, 25, 49, 128, 144, 256)]
# backward: the room over the chain's own error, and its floor
ROOM, FLOOR = 1.02, 2.0 ** -21


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _bits(t):
    ints = {2: torch.int16, 4: torch.int32}
    return t.contiguous().view(ints[t.element_size()])


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))


def _case(gen, rows, c, dtype):
    """Conv-output-like x (per-channel offsets and scales), dy, and the
    parameters in ``dtype``; running statistics float32."""
    dev = "cuda"
    x = (torch.randn((rows, c), generator=gen, device=dev)
         * (0.5 + torch.rand(c, generator=gen, device=dev))
         + torch.randn(c, generator=gen, device=dev))
    dy = torch.randn((rows, c), generator=gen, device=dev)
    weight = 1 + 0.3 * torch.randn(c, generator=gen, device=dev)
    bias = 0.2 * torch.randn(c, generator=gen, device=dev)
    rm = 0.3 * torch.randn(c, generator=gen, device=dev)
    rv = 0.5 + torch.rand(c, generator=gen, device=dev)
    return ([t.to(dtype) for t in (x, dy, weight, bias)], rm, rv)


@pytest.mark.parametrize("rows,c", FUSATNET + FLAGSHIP)
@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_is_normalize_of_its_own_statistics(gen, dtype, rows, c):
    (x, _, weight, bias), rm, rv = _case(gen, rows, c, dtype)
    x.view(-1)[:3] = torch.tensor([float("nan"), -0.0, 0.0]).to(dtype)
    x.view(-1)[c] = float("inf")             # another row, channel 0
    before = _build.launches["bn_train"]
    sums = bn_train.moments(x)
    mean, var, _ = bn_train.statistics(sums)
    for relu in (False, True):
        m, v = rm.clone(), rv.clone()
        y = bn_train.apply(x, sums, weight, bias, EPS, relu, (m, v))
        want = bn_act.normalize(x.float(), mean, var, weight, bias, EPS,
                                dtype, relu)
        _same(y, want)
        _same(m, 0.9 * rm + (1 - 0.9) * mean)
        _same(v, 0.9 * rv + (1 - 0.9) * var)
    torch.cuda.synchronize()
    assert _build.launches["bn_train"] == before + 3


@pytest.mark.parametrize("rows,c", FUSATNET + FLAGSHIP)
@pytest.mark.parametrize("dtype", DTYPES)
def test_moments_are_float64s_sums(gen, dtype, rows, c):
    (x, *_), _, _ = _case(gen, rows, c, dtype)
    got = bn_train.moments(x).double()
    x64 = x.double()
    s1, s2 = x64.sum(0), (x64 * x64).sum(0)
    assert (got[:c] - s1).abs().le(2e-6 * x64.abs().sum(0)).all()
    assert (got[c:2 * c] - s2).abs().le(2e-6 * s2).all()
    assert got[-1] == rows


def _grads(x, dy, weight, bias, rm, rv, relu):
    """(dx, dw, db) of the train-mode BatchNorm of x, in x's and the
    parameters' dtypes, by whichever path the layer takes."""
    bn = ChannelLastBatchNorm(x.shape[-1]).cuda().train()
    with torch.no_grad():
        bn.running_mean.copy_(rm)
        bn.running_var.copy_(rv)
    x, w, b = (t.detach().requires_grad_() for t in (x, weight, bias))
    y = torch.func.functional_call(bn, {"weight": w, "bias": b}, (x,),
                                   {"relu": relu})
    y.backward(dy)
    return x.grad, w.grad, b.grad


def _gap(got, want):
    return float((got.double() - want).norm() / want.norm())


@pytest.mark.parametrize("rows,c", FUSATNET + FLAGSHIP)
@pytest.mark.parametrize("dtype", DTYPES)
def test_backward_no_further_from_float64_than_the_chain(
        gen, monkeypatch, dtype, rows, c):
    (x, dy, weight, bias), rm, rv = _case(gen, rows, c, dtype)
    for relu in (False, True):
        want = _grads(*(t.double() for t in (x, dy, weight, bias, rm, rv)),
                      relu)
        before = _build.launches["bn_train"]
        got = _grads(x, dy, weight, bias, rm, rv, relu)
        torch.cuda.synchronize()
        assert _build.launches["bn_train"] == before + 4
        with monkeypatch.context() as m:
            m.setattr(bn_train, "engages", lambda *a: False)
            chain = _grads(x, dy, weight, bias, rm, rv, relu)
        assert _build.launches["bn_train"] == before + 4
        for name, a, p, w in zip(("dx", "dw", "db"), got, chain, want):
            assert a.dtype == p.dtype and torch.isfinite(a).all()
            assert _gap(a, w) <= max(ROOM * _gap(p, w), FLOOR), (
                name, relu, _gap(a, w), _gap(p, w))


@pytest.mark.parametrize("dtype", DTYPES)
def test_strided_and_misaligned_inputs(gen, dtype):
    rows, c = 4096, 256
    (x, dy, weight, bias), rm, rv = _case(gen, rows, c, dtype)
    wide = torch.zeros((rows, c + 8), dtype=dtype, device="cuda")
    wide[:, 3:c + 3] = x
    nchw = x.t().contiguous().t()                  # a transposed view
    flat = torch.zeros(rows * c + 1, dtype=dtype, device="cuda")
    flat[1:] = x.reshape(-1)
    misaligned = flat[1:].view(rows, c)           # contiguous, misaligned
    dflat = torch.zeros(rows * c + 1, dtype=dtype, device="cuda")
    dflat[1:] = dy.reshape(-1)
    want = _grads(*(t.double() for t in (x, dy, weight, bias, rm, rv)), True)
    base = _grads(x, dy, weight, bias, rm, rv, True)
    for xs, dys in ((wide[:, 3:c + 3], dy), (nchw, dy.t().contiguous().t()),
                    (misaligned, dflat[1:].view(rows, c))):
        sums = bn_train.moments(xs.contiguous())
        mean, var, _ = bn_train.statistics(sums)
        y = bn_train.apply(xs.contiguous(), sums, weight, bias, EPS, True)
        _same(y, bn_act.normalize(xs.float(), mean, var, weight, bias, EPS,
                                  dtype, True))
        got = _grads(xs, dys, weight, bias, rm, rv, True)
        for a, b, w in zip(got, base, want):
            assert _gap(a, w) <= max(ROOM * _gap(b, w), FLOOR)


@pytest.mark.parametrize("rows,c", [(123904, 1024), (82944, 25)])
def test_two_runs_agree_bit_for_bit(gen, rows, c):
    (x, dy, weight, bias), rm, rv = _case(gen, rows, c, torch.bfloat16)
    runs = []
    for _ in range(2):
        m, v = rm.clone(), rv.clone()
        xs, ws, bs = (t.clone().requires_grad_() for t in (x, weight, bias))
        y = bn_train.bn_train(xs, ws, bs, m, v, EPS, 0.9, True)
        y.backward(dy)
        runs.append((y, xs.grad, ws.grad, bs.grad, m, v))
    for a, b in zip(*runs):
        _same(a, b)


def test_a_fusatnet_train_step_launches_four_a_batch_norm(gen):
    """35 train-mode BatchNorms, each 2 passes forward and 2 backward;
    the eval-mode pass never."""
    model = init_parameters(FusAtNet(144, 1, 16), 0).cuda().train()
    forward = bf16_train_apply(model)
    hsi = torch.randn((64, 11, 11, 144), generator=gen, device="cuda")
    lidar = torch.randn((64, 11, 11, 1), generator=gen, device="cuda")
    before = dict(_build.launches)
    F.cross_entropy(forward(hsi, lidar), torch.zeros(
        64, dtype=torch.long, device="cuda")).backward()
    torch.cuda.synchronize()
    assert _build.launches["bn_train"] - before.get("bn_train", 0) == 140
    assert _build.launches["bn_act"] == before.get("bn_act", 0)
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
