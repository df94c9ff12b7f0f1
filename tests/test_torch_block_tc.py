"""The tensor-core Kernel B's launch geometry and C entries, checked without a
card.

``csrc/lvc_block_ncl_tc.cu`` (K1, K2 at hops that are multiples of 8) takes
its tile from ``ops/lvc_block_ncl.py:block_tile_plan``. These tests hold the
Python constants to the source's, hold the tile walk that the kernel does
(block ``bx`` outputs samples ``[bx * tile, bx * tile + tile)`` from an
extent of ``tile + 2 * HALO`` samples, in n8 tiles each read against the
frame of its first sample) to covering every output once with the halo and
frames it needs, and hold the hop test, the launch with the plan's tile
and the C entry's arity.
"""

import re

import numpy as np
import pytest

from fastdiff_tpu_torch.ops import _build
from fastdiff_tpu_torch.ops import lvc_block_ncl as ops
from tests.fake_card import FakeCuda, fake_card

# samples of halo the four layers (sum(d_i + 1) = 44) and the final conv
# (3) consume on each side of an output
HALO_NEEDED = 44 + 3

CASES = [(1, 864, 8), (1, 864, 64), (1, 864, 256), (1, 100, 8), (1, 100, 64),
         (1, 100, 256), (20, 100, 8), (20, 100, 256), (4, 864, 256),
         (2, 3, 64), (1, 1, 8), (3, 37, 16)]


def _source(name: str) -> str:
    return (_build.CSRC / name).read_text()


def _const(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_python_geometry_matches_the_source():
    tc = _source("lvc_block_tc.cuh")
    assert _const(tc, "HALO") == ops.TC_HALO
    assert _const(tc, "C") == ops.KERNEL_CHANNELS
    assert _const(tc, "LAYERS") == ops.KERNEL_LAYERS
    assert _const(tc, "THREADS") == ops.TC_THREADS
    assert _const(tc, "BLOCKS_PER_SM") == ops.TC_BLOCKS_PER_SM
    assert _const(tc, "TILE_MAX") == ops.TC_TILE_MAX
    assert _const(tc, "ROW") == ops.TC_ROW
    assert _const(tc, "WROW") == ops.TC_WROW
    assert _const(tc, "APAD") == ops.TC_APAD == 3 ** (ops.KERNEL_LAYERS - 1)
    assert _const(tc, "YPAD") == ops.TC_YPAD
    assert _const(tc, "SMEM_LIMIT") == ops.SMEM_PER_BLOCK == 232_448
    # the same formula as tc_smem_bytes
    assert ("return (3 * ext + 2 * APAD + 2 * YPAD) * ROW * 2 + C * WROW * 2 "
            "+\n         (C + 8 * C) * 4;") in tc


def test_shared_memory_fits_two_blocks_per_sm():
    ext_max = ops.TC_TILE_MAX + 2 * ops.TC_HALO
    assert ops.tc_smem_bytes(ext_max) == 114_048
    # 228 KB per SM, 1 KB reserved per block
    assert ops.TC_BLOCKS_PER_SM * (ops.tc_smem_bytes(ext_max) + 1024) \
        <= 233_472
    assert ops.tc_smem_bytes(ext_max + 8) * 2 + 2048 > 233_472
    assert ops.tc_smem_bytes(ext_max) <= ops.SMEM_PER_BLOCK
    # 80-byte rows: eight consecutive rows in eight distinct 16-byte bank
    # groups (conflict-free ldmatrix and 16-byte accesses); likewise W_i's
    for stride in (ops.TC_ROW * 2, ops.TC_WROW * 2):
        assert stride % 16 == 0
        assert len({(r * stride) % 128 for r in range(8)}) == 8


@pytest.mark.parametrize("b,frames,hop", CASES)
def test_tile_walk_covers_every_output_once(b, frames, hop):
    length = frames * hop
    plan = ops.block_tile_plan(b, length)
    tile, ext = plan.tile, plan.ext
    assert tile % 8 == 0 and 8 <= tile <= ops.TC_TILE_MAX
    assert ext == tile + 2 * ops.TC_HALO and ext % 8 == 0
    assert plan.blocks == b * -(-length // tile)
    assert plan.waves == -(-plan.blocks // (ops.H100_SMS * 2))
    assert plan.smem_bytes == ops.tc_smem_bytes(ext) <= ops.SMEM_PER_BLOCK
    hits = np.zeros(length, np.int64)
    for bx in range(-(-length // tile)):
        g0 = bx * tile - ops.TC_HALO                   # extent row 0
        lo, hi = bx * tile, min(length, bx * tile + tile)
        hits[lo:hi] += 1
        # every output's halo lies in the extent
        assert g0 <= max(0, lo - HALO_NEEDED)
        assert g0 + ext >= min(length, hi + HALO_NEEDED)
        # each n8 tile reads the frame of its first sample (clamped); when
        # the hop is a multiple of 8 that is the frame of all its samples
        # inside [0, L), so the extent reads every frame its samples need
        read = set()
        for j in range(ext // 8):
            gs = g0 + 8 * j
            f = min(max(gs, 0) // hop, frames - 1)
            read.add(f)
            inside = [g for g in range(gs, gs + 8) if 0 <= g < length]
            if ops.tensor_core_hop(hop):
                assert all(g // hop == f for g in inside)
        needed = {g // hop for g in range(max(0, g0), min(length, g0 + ext))}
        assert needed <= read
    assert (hits == 1).all()


def test_plan_at_the_10s_shapes():
    """The tiles the kernel's header note quotes, at 864 frames."""
    tiles = {hop: ops.block_tile_plan(1, 864 * hop) for hop in (8, 64, 256)}
    assert {hop: (p.tile, p.waves) for hop, p in tiles.items()} == {
        8: (32, 1), 64: (216, 1), 256: (280, 3)}
    # the ncl_vjp forward at the training recipe: b 20 x 100 frames
    assert ops.block_tile_plan(20, 25_600).tile == ops.TC_TILE_MAX


def test_plan_minimises_waves_times_extent():
    for b, length, sms in [(1, 221_184, 132), (1, 55_296, 114),
                           (3, 1_000, 132), (20, 6_400, 132)]:
        plan = ops.block_tile_plan(b, length, sms)
        for tile in range(8, ops.TC_TILE_MAX + 1, 8):
            waves = -(-(b * -(-length // tile)) // (2 * sms))
            assert plan.waves * plan.ext <= waves * (tile + 2 * ops.TC_HALO)


def test_plan_refuses_an_empty_block():
    with pytest.raises(ValueError):
        ops.block_tile_plan(0, 100)


@pytest.mark.parametrize("hop,tensor_cores", [(8, True), (64, True),
                                              (256, True), (16, True),
                                              (4, False), (1, False),
                                              (12, False), (100, False)])
def test_hop_picks_the_kernel(monkeypatch, hop, tensor_cores):
    """A CUDA tensor reaches the tensor-core entry with the plan's tile when
    ``tensor_core_hop(hop)`` (K2's launch counted apart, with the epilogue),
    else raises naming the hop before any launch."""
    assert ops.tensor_core_hop(hop) is tensor_cores
    lib = fake_card(monkeypatch, ops)
    c, layers, rows_p = ops.KERNEL_CHANNELS, ops.KERNEL_LAYERS, 104
    b, frames = 20, 100
    x = FakeCuda((b, c, frames * hop))
    kern = FakeCuda((b, frames, layers, 2 * c, rows_p))
    wstack_t = FakeCuda((layers, c, 3 * c + 1))
    for final_wb, key in ((None, "lvc_block_ncl"),
                          (FakeCuda((8, c)), "lvc_block_ncl_final")):
        before = dict(ops.LAUNCHES)
        if not tensor_cores:
            with pytest.raises(ValueError, match=f"hop {hop}"):
                ops.lvc_block_ncl(x, x, kern, wstack_t, hop, final_wb)
            assert lib.calls == [] and ops.LAUNCHES == before
            continue
        ops.lvc_block_ncl(x, x, kern, wstack_t, hop, final_wb)
        (name, args), = lib.calls
        lib.calls.clear()
        tile = ops.block_tile_plan(b, frames * hop, 132).tile
        assert name == "lvc_block_ncl_launch"
        assert args[7:] == (b, c, frames * hop, frames, hop, rows_p, layers,
                            tile, 0)
        assert ops.LAUNCHES == dict(before, **{key: before[key] + 1})


def test_block_entries_take_the_tile():
    """The tensor-core entry takes the operands, the shapes and the plan's
    tile before the stream, as its definition in the source does."""
    tc = _build.SIGNATURES["lvc_block_ncl_launch"]
    assert tc == [_build._P] * 7 + [_build._I] * 8 + [_build._P]
    m = re.search(r'extern "C" int lvc_block_ncl_launch\(([^)]*)\)',
                  _source("lvc_block_ncl_tc.cu"))
    params = [p.split()[-1] for p in m.group(1).split(",")]
    assert len(params) == len(tc) and params[-2:] == ["tile", "stream"]


def test_experiment_variants_apply():
    """``scripts/exp_block_tc.py`` edits the kernel's source into its
    variants; the lines it removes are still there."""
    from fastdiff_tpu_torch.scripts import exp_block_tc
    sources = exp_block_tc.variant_sources()
    assert set(sources) == {"kernel", "no_lvc", "no_conv", "io_only"}
    assert sources["kernel"] == _source("lvc_block_ncl_tc.cu")
    # the stage calls, with the SAVE flag of Kernel B-SR
    lvc, conv = "lvc_gate_tc<WIDE, SAVE>(", "conv_tc<WIDE, SAVE>("
    assert lvc in sources["kernel"] and conv in sources["kernel"]
    assert lvc not in sources["no_lvc"]
    assert conv not in sources["no_conv"]
    assert lvc not in sources["io_only"]
    assert conv not in sources["io_only"]
    assert "skip_add<SAVE>(" in sources["io_only"]
