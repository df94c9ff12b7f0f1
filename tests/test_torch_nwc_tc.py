"""The tensor-core K6's launch geometry, dispatch and C entry, checked
without a card.

``csrc/lvc_block_nwc_tc.cu`` (K6 at hops that are multiples of 8) takes K1's
tile from ``ops/lvc_block_pallas.py:nwc_tile_plan`` with its own shared
memory: the conv's input shares its bytes with a ring of two K_{i,f} slabs
brought by TMA. These tests hold the Python constants to the source's, hold
the walk the kernel does (block ``bx`` outputs ``[bx * tile, bx * tile +
tile)``; per layer it visits the frames of the extent's samples inside
[0, L) in order and, in each, the n8 tiles of those samples) to covering
every output once with every frame it needs, and hold the hop test, the
launch with the plan's numbers and the C entry.
"""

import re

import numpy as np
import pytest

from fastdiff_tpu_torch.ops import _build
from fastdiff_tpu_torch.ops import lvc_block_ncl as ncl
from fastdiff_tpu_torch.ops import lvc_block_pallas as ops
from tests.fake_card import FakeCuda, fake_card

CASES = [(1, 864, 64), (1, 864, 256), (2, 100, 64), (1, 100, 64),
         (2, 100, 256), (1, 2, 64), (3, 7, 16), (1, 40, 8)]


def _source() -> str:
    return (_build.CSRC / "lvc_block_nwc_tc.cu").read_text()


def _const(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_python_geometry_matches_the_source():
    src = _source()
    assert _const(src, "NWC_STAGES") == ops.NWC_STAGES
    assert _const(src, "NWC_SLOT") == ops.NWC_SLOT
    assert _const(src, "NWC_ALIGN") == ops.NWC_ALIGN
    # the same formulas as nwc_smem_bytes
    assert ("return NWC_ALIGN + nwc_union_bytes(ext) + (2 * ext + 2 * YPAD) "
            "* ROW * 2 +\n         C * WROW * 2 + C * 4 + 16;") in src
    assert "(ext + 2 * APAD) * ROW * 2 > NWC_STAGES * NWC_SLOT" in src


def test_shared_memory_fits_two_blocks_per_sm():
    slab = 97 * 64 * 2
    assert slab == 12_416 <= ops.NWC_SLOT and ops.NWC_SLOT % 1024 == 0
    ext_max = ncl.TC_TILE_MAX + 2 * ncl.TC_HALO
    assert ops.nwc_smem_bytes(ext_max) == 114_064
    assert 2 * (ops.nwc_smem_bytes(ext_max) + 1024) <= 233_472
    # the ring shares the conv input's bytes: at the smallest extent the
    # ring sets the size, at K1's largest the conv's input (with its pads)
    for ext, ring_sets_it in ((104, True), (ext_max, False)):
        a_bytes = (ext + 2 * ncl.TC_APAD) * ncl.TC_ROW * 2
        rest = ops.nwc_smem_bytes(ext) - max(a_bytes, 2 * ops.NWC_SLOT)
        assert rest == 1024 + (2 * ext + 2) * 80 + 32 * 104 * 2 + 128 + 16
        assert (2 * ops.NWC_SLOT > a_bytes) is ring_sets_it


@pytest.mark.parametrize("b,frames,hop", CASES)
def test_walk_covers_every_output_once(b, frames, hop):
    length = frames * hop
    plan = ops.nwc_tile_plan(b, length)
    tile, ext = plan.tile, plan.ext
    assert plan.smem_bytes == ops.nwc_smem_bytes(ext)
    assert 2 * (plan.smem_bytes + 1024) <= 233_472
    hits = np.zeros(length, np.int64)
    for bx in range(-(-length // tile)):
        g0 = bx * tile - ncl.TC_HALO
        lo, hi = max(g0, 0), min(g0 + ext, length)
        assert lo < hi
        hits[bx * tile:min(length, bx * tile + tile)] += 1
        f_lo = lo // hop
        nf = (hi - 1) // hop - f_lo + 1
        lvc = np.zeros(length, np.int64)
        for j in range(nf):
            f = f_lo + j
            e_a = max(f * hop, lo) - g0
            e_b = min((f + 1) * hop, hi) - g0
            assert e_a % 8 == 0 and e_b % 8 == 0 and e_b > e_a
            for t in range((e_b - e_a) // 8):
                samples = g0 + e_a + 8 * t + np.arange(8)
                assert (samples // hop == f).all()     # one frame per tile
                lvc[samples] += 1
        # every sample of the extent inside [0, L) runs the LVC once
        assert (lvc[lo:hi] == 1).all() and lvc.sum() == hi - lo
    assert (hits == 1).all()


def test_plan_at_the_10s_shapes():
    """K1's tiles at the route's two hops, 864 frames."""
    p64 = ops.nwc_tile_plan(1, 864 * 64)
    p256 = ops.nwc_tile_plan(1, 864 * 256)
    assert (p64.tile, p64.waves, p64.smem_bytes) == (216, 1, 87_184)
    assert (p256.tile, p256.waves, p256.smem_bytes) == (280, 3, 102_544)


@pytest.mark.parametrize("hop,tensor_cores", [(64, True), (256, True),
                                              (16, True), (12, False),
                                              (4, False)])
def test_hop_picks_the_kernel(monkeypatch, hop, tensor_cores):
    """A CUDA tensor reaches the tensor-core entry with the plan's tile and
    shared memory when ``tensor_core_hop(hop)``, else raises naming the hop
    before any launch."""
    lib = fake_card(monkeypatch, ops)
    c, layers, b, frames = ops.KERNEL_CHANNELS, ops.KERNEL_LAYERS, 1, 10
    rows = ops.aug_rows(c)
    x = FakeCuda((b, frames * hop, c))
    kern_aug = FakeCuda((b, frames, layers, rows, 2 * c))
    wstack = FakeCuda((layers, rows, c))
    before = dict(ops.LAUNCHES)
    if not tensor_cores:
        with pytest.raises(ValueError, match=f"hop {hop}"):
            ops.lvc_block_nwc(x, x, kern_aug, wstack, hop)
        assert lib.calls == [] and ops.LAUNCHES == before
        return
    ops.lvc_block_nwc(x, x, kern_aug, wstack, hop)
    (name, args), = lib.calls
    plan = ops.nwc_tile_plan(b, frames * hop, 132)
    assert name == "lvc_block_nwc_launch"
    assert args[5:] == (b, c, frames * hop, frames, hop, rows, layers,
                        plan.tile, plan.smem_bytes, 0)
    assert ops.LAUNCHES == dict(before, lvc_block_nwc=before[
        "lvc_block_nwc"] + 1)


def test_entries_take_the_plan():
    """The tensor-core entry takes the operands, the shapes and the plan's
    tile and shared memory before the stream, as its definition in the
    source does."""
    tc = _build.SIGNATURES["lvc_block_nwc_launch"]
    assert tc == [_build._P] * 5 + [_build._I] * 9 + [_build._P]
    m = re.search(r'extern "C" int lvc_block_nwc_launch\(([^)]*)\)',
                  _source())
    assert len(m.group(1).split(",")) == len(tc)
