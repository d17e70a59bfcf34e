"""K1's tile helper and the C signatures of K1 and K2, on the CPU.

``ops/selective_scan.py`` ``scan_tile`` plans K1's launch (channels per
thread R; 4 warps per block) by the formula the C entry point uses
(``plan`` in ``csrc/selective_scan_fwd.cu``; the card tests hold the two
equal). Here it is walked over the shape domain in both dtypes: every
tile must give a launchable geometry (grid and block limits, shared
memory), cover every channel exactly once with at most one partly filled
block of channels, and fill the card at the flagship's shapes, serving
and training (in bf16 with no padded channel). The
ctypes signatures of ``vct_selective_scan`` and ``vct_dir_conv_silu``
are the ones the earlier kernels had.
"""

import ctypes
import re
from pathlib import Path

import pytest
import torch

from vit_cnn_tpu_torch.ops import _build, selective_scan
from vit_cnn_tpu_torch.ops.attention import SMEM_LIMIT
from vit_cnn_tpu_torch.ops.selective_scan import scan_tile

SOURCE = (Path(selective_scan.__file__).resolve().parent.parent / "csrc"
          / "selective_scan_fwd.cu")
BATCHES = (1, 2, 31, 32, 33, 63, 64, 65, 1000, 1001, 1023, 1024, 1025,
           7587, 7588, 8191, 40959, 40960)
FLAGSHIP = [(ns, d, b) for ns in (4, 6) for d in (72, 128)
            for b in (1024, 1001, 7588, 40960)]


def _geometry(ns, L, d, n, b, dtype=torch.bfloat16):
    R, rows = scan_tile(ns, L, d, n, b, dtype)
    groups = -(-d // R)
    grid = (-(-b // selective_scan.SCAN_LANES), -(-groups // rows), ns)
    return R, rows, groups, grid


def _check(ns, L, d, n, b, dtype=torch.bfloat16):
    R, rows, groups, grid = _geometry(ns, L, d, n, b, dtype)
    assert R in (2, 4) and rows == selective_scan.SCAN_ROWS
    assert rows * R <= 16                       # the kernel's A staging
    assert 1 <= grid[0] <= 2 ** 31 - 1
    assert 1 <= grid[1] <= 65535 and 1 <= grid[2] <= 65535
    # channel c is (block y, warp, r) = divmod chain of c: every channel
    # of [0, d) once, and only the last block of channels partly empty
    per_block = rows * R
    assert grid[1] * per_block >= d > (grid[1] - 1) * per_block
    assert grid[1] * rows - groups < rows


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ns", range(1, 11))
def test_every_tile_is_launchable(ns, dtype):
    for d in range(1, 257):
        for b in BATCHES:
            _check(ns, 81, d, 16, b, dtype)


@pytest.mark.parametrize("L", [1, 2, 3, 49, 81, 196])
@pytest.mark.parametrize("n", [1, 7, 16])
def test_length_and_state_do_not_move_the_tile(L, n):
    for ns, d, b in FLAGSHIP + [(1, 5, 33), (10, 256, 1)]:
        assert scan_tile(ns, L, d, n, b) == scan_tile(ns, 81, d, 16, b)
        _check(ns, L, d, n, b)


def test_static_staging_fits():
    assert selective_scan.SCAN_SMEM <= 48 * 1024 <= SMEM_LIMIT


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ns,d,b", FLAGSHIP)
def test_flagship_launches_fill_the_card(ns, d, b, dtype):
    """Serving (b = 7,588 windows a band, 40,960 the probes') and training
    (b = 1,024 and a ragged last batch) get two waves of warps; bf16 pads
    no channel; float32 takes R = 4 wherever that still holds."""
    R, rows, groups, grid = _geometry(ns, 81, d, 16, b, dtype)
    warps = ns * grid[1] * rows * grid[0]
    assert warps >= selective_scan.SCAN_FILL_WARPS
    if dtype == torch.bfloat16:
        assert R == 2 and grid[1] * rows * R == d
    else:
        fills4 = ns * -(-d // (4 * rows)) * rows * grid[0] >= \
            selective_scan.SCAN_FILL_WARPS
        assert R == (4 if fills4 else 2)


@pytest.mark.parametrize("ns,d,b,dtype,want", [
    (6, 72, 7588, torch.bfloat16, (2, 4)), (6, 128, 7588, torch.bfloat16,
                                            (2, 4)),
    (6, 72, 7588, torch.float32, (4, 4)), (4, 128, 7588, torch.float32,
                                           (4, 4)),
    (6, 128, 1024, torch.float32, (4, 4)), (4, 128, 1024, torch.float32,
                                            (2, 4)),
    (4, 72, 1024, torch.float32, (2, 4)), (1, 1, 1, torch.float32, (2, 4))])
def test_tiles_at_known_shapes(ns, d, b, dtype, want):
    assert scan_tile(ns, 81, d, 16, b, dtype) == want


@pytest.mark.parametrize("ns,n", [(1, 0), (1, 17), (65536, 16)])
def test_refused_shapes_raise(ns, n):
    with pytest.raises(ValueError, match="K1 takes"):
        scan_tile(ns, 81, 72, n, 64)


def test_c_plan_uses_the_same_constants():
    """The C formula's constants (the card tests compare its tiles)."""
    src = SOURCE.read_text()
    const = lambda name: re.search(
        r"constexpr \w+(?: \w+)? {} = ([^;]+);".format(name), src).group(1)
    assert const("kFillWarps") == "2LL * 132 * 16"
    assert 2 * 132 * 16 == selective_scan.SCAN_FILL_WARPS
    assert const("kRows") == str(selective_scan.SCAN_ROWS)
    assert const("kMaxN") == str(selective_scan.SCAN_MAX_N)
    assert const("kLanes") == str(selective_scan.SCAN_LANES)
    assert const("kChunk") == str(selective_scan.SCAN_CHUNK)


_I, _P = ctypes.c_int, ctypes.c_void_p


@pytest.mark.parametrize("entry,want", [
    ("vct_selective_scan", [_I] + [_P] * 7 + [_I] * 6 + [_P]),
    ("vct_dir_conv_silu", [_I] + [_P] * 7 + [_I] * 6 + [_P])])
def test_kernel_signatures_are_unchanged(entry, want):
    """dtype, u, dt, A, B, C, D, y, ns, L, d, n, b, reverse, stream; and
    dtype, u, cw, cb, orders, rev_rows, fwd, rev, L, d, b, nb, nr, k,
    stream."""
    assert _build._SIGNATURES[entry] == want
