"""The tensor-core K6's launch geometry, dispatch and C entries, checked
without a card.

``csrc/lvc_block_nwc_tc.cu`` (K6 at hops that are multiples of 8) takes K1's
tile from ``ops/lvc_block_pallas.py:nwc_tile_plan`` with its own shared
memory: the conv's input shares its bytes with a ring of two K_{i,f} slabs
brought by TMA. These tests hold the Python constants to the source's, hold
the walk the kernel does (block ``bx`` outputs ``[bx * tile, bx * tile +
tile)``; per layer it visits the frames of the extent's samples inside
[0, L) in order and, in each, the n8 tiles of those samples) to covering
every output once with every frame it needs, and hold the hop test, the
CUDA-core fallback and the C entries.
"""

import re
import types

import numpy as np
import pytest
import torch

from fastdiff_tpu_torch.ops import _build
from fastdiff_tpu_torch.ops import lvc_block_ncl as ncl
from fastdiff_tpu_torch.ops import lvc_block_pallas as ops

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


def _fake_cuda(b, length, c=32):
    return types.SimpleNamespace(
        device=types.SimpleNamespace(type="cuda", index=0),
        shape=(b, length, c))


@pytest.mark.parametrize("hop,entry", [(64, "lvc_block_nwc_launch"),
                                       (256, "lvc_block_nwc_launch"),
                                       (16, "lvc_block_nwc_launch"),
                                       (12, "lvc_block_nwc_cc_launch"),
                                       (4, "lvc_block_nwc_cc_launch")])
def test_hop_picks_the_kernel(monkeypatch, hop, entry):
    """A CUDA tensor goes to the tensor-core entry with the plan's tile and
    shared memory when ``tensor_core_hop(hop)``, else to the CUDA-core
    entry; the choice is made by shape, before any launch."""
    seen = []
    monkeypatch.setattr(ops, "_sm_count", lambda index: 132)
    monkeypatch.setattr(ops, "_launch_nwc",
                        lambda name, extra, key, *a: seen.append(
                            (name, extra, key)))
    x = _fake_cuda(1, 10 * hop)
    ops.lvc_block_nwc(x, x, None, None, hop)
    (name, extra, key), = seen
    assert name == entry
    if name == "lvc_block_nwc_launch":
        plan = ops.nwc_tile_plan(1, 10 * hop)
        assert extra == (plan.tile, plan.smem_bytes) and key == "lvc_block_nwc"
    else:
        assert extra == () and key == "lvc_block_nwc_cc"


def test_cuda_core_wrapper_runs_plain_on_cpu():
    rng = np.random.default_rng(0)
    b, c, frames, hop = 1, 8, 5, 4
    x, skip = (torch.from_numpy(rng.normal(size=(b, frames * hop, c))
                                .astype(np.float32)) for _ in range(2))
    kern_aug = torch.from_numpy(
        (rng.normal(size=(b, frames, 4, 3 * c + 1, 2 * c)) * 0.1)
        .astype(np.float32))
    wstack = torch.from_numpy(
        (rng.normal(size=(4, 3 * c + 1, c)) * 0.1).astype(np.float32))
    before = dict(ops.LAUNCHES)
    got = ops.lvc_block_nwc_cc(x, skip, kern_aug, wstack, hop)
    ref = ops.lvc_block_nwc_plain(x, skip, kern_aug, wstack, hop)
    assert torch.equal(got, ref)
    assert ops.LAUNCHES == before


def test_entries_take_the_plan():
    """The tensor-core entry takes the CUDA-core entry's arguments and the
    plan's tile and shared memory before the stream; both are defined."""
    tc = _build.SIGNATURES["lvc_block_nwc_launch"]
    cc = _build.SIGNATURES["lvc_block_nwc_cc_launch"]
    assert tc[:-3] == cc[:-1] and tc[-3:-1] == [_build._I] * 2
    assert tc[-1] is cc[-1] is _build._P
    assert 'extern "C" int lvc_block_nwc_launch(' in _source()
    assert 'extern "C" int lvc_block_nwc_cc_launch(' in (
        _build.CSRC / "lvc_block_ncl.cu").read_text()
