"""The eval-mode BatchNorm pass (``csrc/bn_act.cu``) against its plain
chain on the card, bit for bit: NaN, +-inf and -0 positions included, in
float32 and bfloat16, with and without the conv bias and the ReLU, at
FusAtNet's widths (128, 256, 1,024 at 11 x 11, 5 x 5, 2 x 2, 1 x 1) and
the flagship's (1, 16, 25, 49, 128, 144, 256), on strided, transposed and
misaligned inputs; per-channel vectors in another dtype than x's keep the
plain chain. The per-channel constants (``rsqrt(var + eps) * weight``)
equal torch's over a wide range of variances. One band of FusAtNet and of
the flagship served through ``bf16_apply`` gives the plain path's logits
bit for bit, with 35 and 16 launches of the pass a forward; a train step
launches none.

These tests need a CUDA card and skip without one. On the GPU host:

    python -m pytest --noconftest tests/test_torch_bn_act_cuda.py -q
"""

import pytest
import torch
import torch.nn.functional as F

from vit_cnn_tpu_torch.models.fusatnet import FusAtNet
from vit_cnn_tpu_torch.models.mm_mamba import MultimodalityMamba
from vit_cnn_tpu_torch.nn.layers import ChannelLastBatchNorm, init_parameters
from vit_cnn_tpu_torch.nn.precision import bf16_apply, bf16_train_apply
from vit_cnn_tpu_torch.ops import _build, bn_act

pytestmark = pytest.mark.cuda
DTYPES = [torch.float32, torch.bfloat16]
# (C, spatial side): FusAtNet's units, then the flagship's BatchNorms
SHAPES = [(128, 11), (256, 11), (256, 5), (1024, 11), (1024, 2), (1024, 1),
          (1, 9), (16, 7), (25, 7), (49, 9), (128, 5), (144, 5), (256, 7)]


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


def _vectors(gen, c, dtype):
    """mean, var, weight, bias as a seeded checkpoint has them; one
    channel's weight 0 (NonLocal's zero-initialised BN)."""
    dev = "cuda"
    mean = 0.3 * torch.randn(c, generator=gen, device=dev)
    var = torch.rand(c, generator=gen, device=dev) * 3 + 1e-3
    weight = 1 + 0.2 * torch.randn(c, generator=gen, device=dev)
    weight[0] = 0
    bias = 0.2 * torch.randn(c, generator=gen, device=dev)
    return [t.to(dtype) for t in (mean, var, weight, bias)]


def _input(gen, shape, dtype):
    x = (2 * torch.randn(shape, generator=gen, device="cuda")).to(dtype)
    x.view(-1)[:5] = torch.tensor([float("nan"), float("inf"),
                                   -float("inf"), -0.0, 0.0]).to(dtype)
    return x


def _both(x, vectors, cb, relu):
    want = bn_act.bn_act_reference(x, *vectors, 1e-5, cb, relu)
    before = _build.launches["bn_act"]
    with torch.no_grad():
        got = bn_act.bn_act(x, *vectors, 1e-5, cb, relu)
    torch.cuda.synchronize()
    assert _build.launches["bn_act"] == before + 1
    return got, want


@pytest.mark.parametrize("c,side", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_equals_plain_chain(gen, dtype, c, side):
    x = _input(gen, (37, side, side, c), dtype)
    vectors = _vectors(gen, c, dtype)
    cb = 0.1 * torch.randn(c, generator=gen, device="cuda").to(dtype)
    for bias in (None, cb):
        for relu in (False, True):
            _same(*_both(x, vectors, bias, relu))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(7580, 11, 11, 128), (7588, 7, 7, 25),
                                   (3001, 9, 9, 1)])
def test_kernel_strides_over_a_band(gen, dtype, shape):
    """More vectors than resident threads: the grid strides, each thread
    keeping its channels (C = 25 and 1: the one-value path)."""
    x = _input(gen, shape, dtype)
    vectors = _vectors(gen, shape[-1], dtype)
    cb = 0.1 * torch.randn(shape[-1], generator=gen, device="cuda").to(dtype)
    _same(*_both(x, vectors, cb, True))


@pytest.mark.parametrize("dtype", DTYPES)
def test_vectors_in_another_dtype_keep_the_plain_chain(gen, dtype):
    """Per-channel vectors in another dtype than x's (no serving path
    has them): the plain chain, no launch."""
    x = _input(gen, (64, 5, 5, 256), dtype)
    other = torch.bfloat16 if dtype == torch.float32 else torch.float32
    vectors = _vectors(gen, 256, dtype)
    for i in range(4):
        mixed = [v.to(other) if j == i else v for j, v in enumerate(vectors)]
        before = _build.launches["bn_act"]
        with torch.no_grad():
            got = bn_act.bn_act(x, *mixed, 1e-5, None, True)
        assert _build.launches["bn_act"] == before
        _same(got, bn_act.bn_act_reference(x, *mixed, 1e-5, None, True))


@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_reads_non_contiguous_and_misaligned_inputs(gen, dtype):
    c = 256
    vectors = _vectors(gen, c, dtype)
    wide = _input(gen, (40, 5, 5, c + 8), dtype)
    nchw = _input(gen, (40, c, 5, 5), dtype)
    flat = _input(gen, (40 * 25 * c + 1,), dtype)
    for x in (wide[..., 3:c + 3],                  # strided rows, offset
              nchw.movedim(1, -1),                 # channels-last view
              flat[1:].view(40, 5, 5, c)):         # contiguous, misaligned
        _same(*_both(x, vectors, None, True))
        _same(*_both(x, vectors, vectors[3], False))


def test_per_channel_constants_equal_torch(gen):
    """mul = rsqrt(var + eps) * weight, read through the float32 pass at
    x = 1, mean 0, bias 0: the kernel's rsqrt is torch's, bit for bit,
    over variances from 0 to 1e6."""
    c = 1 << 20
    var = torch.cat([torch.zeros(1, device="cuda"), torch.logspace(
        -12, 6, c - 1, device="cuda")])
    weight = torch.randn(c, generator=gen, device="cuda")
    zeros = torch.zeros(c, device="cuda")
    x = torch.ones((3, c), device="cuda")
    with torch.no_grad():
        got = bn_act.bn_act(x, zeros, var, weight, zeros, 1e-5)
    want = torch.rsqrt(var + 1e-5) * weight
    _same(got, want.expand(3, c))


def _randomize_bn(model, gen):
    """Seeded running statistics, scales and shifts in every BatchNorm,
    and conv biases, so that each channel's constants differ."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, ChannelLastBatchNorm):
                for t, v in zip((m.running_mean, m.running_var, m.weight,
                                 m.bias), _vectors(gen, m.weight.numel(),
                                                   torch.float32)):
                    t.copy_(v)
        for name, p in model.named_parameters():
            if name.endswith("Conv_0.bias"):
                p.normal_(0, 0.05, generator=gen)


@pytest.mark.parametrize("name,windows,units", [("FusAtNet", 7580, 35),
                                                ("flagship", 7588, 16)])
def test_a_band_is_the_plain_path_bit_for_bit(gen, monkeypatch, name,
                                              windows, units):
    """One band of windows served through bf16_apply: the logits equal
    the plain chain's; the pass launches once a BatchNorm a forward."""
    if name == "FusAtNet":
        model, p = FusAtNet(144, 1, 16), 11
    else:
        model, p = MultimodalityMamba(9, 144, 1, 64, 16), 9
    model = init_parameters(model, 0).cuda().eval()
    _randomize_bn(model, gen)
    forward = bf16_apply(model)
    hsi = torch.randn((windows, p, p, 144), generator=gen, device="cuda")
    lidar = torch.randn((windows, p, p, 1), generator=gen, device="cuda")
    with torch.inference_mode():
        before = _build.launches["bn_act"]
        got = forward(hsi, lidar)
        torch.cuda.synchronize()
        assert _build.launches["bn_act"] == before + units
        with monkeypatch.context() as m:
            m.setattr(bn_act, "engages", lambda x, *t: False)
            want = forward(hsi, lidar)
    assert _build.launches["bn_act"] == before + units
    assert torch.isfinite(got).all()
    _same(got, want)


def test_a_train_step_launches_no_pass(gen):
    model = init_parameters(FusAtNet(144, 1, 16), 0).cuda().train()
    forward = bf16_train_apply(model)
    before = _build.launches["bn_act"]
    hsi = torch.randn((64, 11, 11, 144), generator=gen, device="cuda")
    lidar = torch.randn((64, 11, 11, 1), generator=gen, device="cuda")
    F.cross_entropy(forward(hsi, lidar), torch.zeros(
        64, dtype=torch.long, device="cuda")).backward()
    torch.cuda.synchronize()
    assert _build.launches["bn_act"] == before
