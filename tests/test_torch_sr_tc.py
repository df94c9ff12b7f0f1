"""Kernel B-SR (K4) on the tensor cores: its residual stores, dispatch and C
entries, checked without a card.

``csrc/lvc_block_ncl_tc.cu`` with ``SAVE`` is the tensor-core Kernel B
(K1's tile from ``ops/lvc_block_ncl.py:block_tile_plan``) writing s, y and
z of every layer for the tile's own samples. These tests hold the source to
the Python constants, model the three store walks of ``csrc/
lvc_block_tc.cuh`` (``skip_add``'s pairs of samples, ``conv_tc``'s lanes
and ``lvc_gate_tc``'s runs of n8 tiles) to show that every (c, l) of each
layer's plane is written exactly once at the training recipe's shapes and
at ragged ones, show that the hop-8 y store puts channel c at row c though
ybuf holds y permuted, and hold the dispatch by hop and the C entry.
"""

import re

import numpy as np
import pytest

from fastdiff_tpu_torch.ops import _build
from fastdiff_tpu_torch.ops import lvc_block_ncl as ops
from tests.fake_card import FakeCuda, fake_card

C = ops.KERNEL_CHANNELS
HALO = ops.TC_HALO
THREADS = ops.TC_THREADS
WARPS = THREADS // 32

# the training recipe (b 20 x 100 frames at each hop) and ragged blocks
CASES = [(20, 100, 8), (20, 100, 64), (20, 100, 256), (3, 37, 16),
         (2, 3, 64), (1, 1, 8), (1, 13, 24)]


def _source(name: str) -> str:
    return (_build.CSRC / name).read_text()


def _const(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_python_constants_match_the_source():
    tc = _source("lvc_block_tc.cuh")
    assert _const(tc, "HALO") == HALO
    assert _const(tc, "C") == C
    assert _const(tc, "LAYERS") == ops.KERNEL_LAYERS
    assert _const(tc, "THREADS") == THREADS
    assert _const(tc, "TILE_MAX") == ops.TC_TILE_MAX
    kernel = _source("lvc_block_ncl_tc.cu")
    # SAVE defaults off (K1, K2 unchanged) and is built at hop 8 and others
    assert "template <bool FINAL, bool WIDE, bool SAVE = false>" in kernel
    assert ("hop == 8 ? launch<false, true, true> : "
            "launch<false, false, true>") in kernel
    # each layer's planes: (C, L) of s and y, (2C, L) of z per batch row
    assert "((size_t)b * LAYERS + i) * C * L" in kernel
    assert "z_all + 2 * plane" in kernel


def _centre(e, g, tile, length):
    return HALO <= e < HALO + tile and g < length


def _store_walks(b, length, hop):
    """Hits per (c, l) of one batch row's s, y and z planes (every layer
    runs the same walks) over the grid of ``block_tile_plan``."""
    plan = ops.block_tile_plan(b, length)
    tile, ext = plan.tile, plan.ext
    grid_x = -(-length // tile)
    assert plan.blocks == b * grid_x          # grid (grid_x, b)
    s = np.zeros((C, length), np.int64)
    y = np.zeros((C, length), np.int64)
    z = np.zeros((2 * C, length), np.int64)
    lanes = [(lane >> 2, lane & 3) for lane in range(32)]
    nt = ext // 8
    runs = WARPS // 2
    per = -(-nt // runs)
    for bx in range(grid_x):
        g0 = bx * tile - HALO
        # skip_add: thread tid takes sample pairs e = 2 tid + 2 THREADS k
        for tid in range(THREADS):
            for e in range(2 * tid, ext, 2 * THREADS):
                g = g0 + e
                if _centre(e, g, tile, length):
                    for q in range(C // 8):
                        for j in range(8):
                            s[8 * q + j, g:g + 2] += 1
        # conv_tc: warp w takes n8 tiles w, w + WARPS, ...; lane (gq, tq)
        # holds channels 16 m + gq + 8 h at samples n0 + 2 tq, + 1
        for w in range(WARPS):
            for j in range(w, nt, WARPS):
                for gq, tq in lanes:
                    e = 8 * j + 2 * tq
                    g = g0 + e
                    if _centre(e, g, tile, length):
                        for m in range(2):
                            for h in range(2):
                                y[16 * m + gq + 8 * h, g:g + 2] += 1
        # lvc_gate_tc: warp w owns the m16 pair p = w & 1 over a run of
        # contiguous n8 tiles; a tile is saved whole or not at all
        for w in range(WARPS):
            p = w & 1
            j0 = (w >> 1) * per
            for j in range(j0, min(nt, j0 + per)):
                n0 = 8 * j
                inside = [_centre(n0 + i, g0 + n0 + i, tile, length)
                          for i in range(8)]
                assert len(set(inside)) == 1
                if not inside[0]:
                    continue
                for gq, tq in lanes:
                    g = g0 + n0 + 2 * tq
                    for mm in range(2):
                        for h in range(2):
                            z[C * mm + 16 * p + gq + 8 * h, g:g + 2] += 1
    return s, y, z


@pytest.mark.parametrize("b,frames,hop", CASES)
def test_store_walks_write_every_residual_once(b, frames, hop):
    s, y, z = _store_walks(b, frames * hop, hop)
    for name, hits in (("s", s), ("y", y), ("z", z)):
        assert (hits == 1).all(), (name, int(hits.min()), int(hits.max()))


def _ypos(c: int) -> int:
    t, i = c >> 3, c & 7
    return ((i & 4) << 2) + 2 * t + (i & 1) + ((i & 2) << 2)


def test_hop8_y_store_is_in_channel_order():
    """At hop 8 (WIDE) conv_tc writes channel o to ybuf column ypos(o), the
    LVC's contraction order; the saved y takes the same lane's accumulator
    of channel o to row o of y_all."""
    src = _source("lvc_block_tc.cuh")
    assert ("return ((i & 4) << 2) + 2 * t + (i & 1) + ((i & 2) << 2);"
            in src)
    assert "ybuf[e * ROW + (WIDE ? ypos(o) : o)]" in src
    assert "y_save + (size_t)o * L + g" in src
    perm = [_ypos(c) for c in range(C)]
    assert sorted(perm) == list(range(C)) and perm != list(range(C))
    inverse = np.argsort(perm)
    value = np.arange(C) * 10 + 7            # y of channel c, one sample
    ybuf = np.zeros(C, np.int64)
    y_all = np.zeros(C, np.int64)
    for lane in range(32):
        gq = lane >> 2
        for m in range(2):
            for h in range(2):
                o = 16 * m + gq + 8 * h
                ybuf[_ypos(o)] = value[o]    # the LVC's operand
                y_all[o] = value[o]          # the saved residual
    assert (y_all == value).all()
    assert (ybuf[perm] == value).all() and (ybuf != value).any()
    assert (ybuf == value[inverse]).all()


@pytest.mark.parametrize("hop,tensor_cores", [(8, True), (64, True),
                                              (256, True), (16, True),
                                              (12, False), (4, False),
                                              (1, False)])
def test_hop_picks_the_kernel(monkeypatch, hop, tensor_cores):
    """A CUDA tensor reaches the tensor-core entry with the plan's tile when
    ``tensor_core_hop(hop)``, else raises naming the hop before any
    launch."""
    lib = fake_card(monkeypatch, ops)
    layers, rows_p, b, frames = ops.KERNEL_LAYERS, 104, 20, 100
    x = FakeCuda((b, C, frames * hop))
    kern = FakeCuda((b, frames, layers, 2 * C, rows_p))
    wstack_t = FakeCuda((layers, C, 3 * C + 1))
    before = dict(ops.LAUNCHES)
    if not tensor_cores:
        with pytest.raises(ValueError, match=f"hop {hop}"):
            ops.lvc_block_ncl_sr(x, x, kern, wstack_t, hop)
        assert lib.calls == [] and ops.LAUNCHES == before
        return
    out, s_all, y_all, z_all = ops.lvc_block_ncl_sr(x, x, kern, wstack_t, hop)
    (name, args), = lib.calls
    tile = ops.block_tile_plan(b, frames * hop, 132).tile
    assert name == "lvc_block_ncl_sr_launch"
    assert args[7] == z_all.data_ptr()
    assert args[8:] == (b, C, frames * hop, frames, hop, rows_p, layers,
                        tile, 0)
    assert ops.LAUNCHES == dict(before, lvc_block_ncl_sr=before[
        "lvc_block_ncl_sr"] + 1)


def _arity(src: str, name: str) -> int:
    m = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
    return len([p for p in m.group(1).split(",") if p.strip()])


def test_entries_match_their_signatures():
    """The tensor-core entry's parameter count matches ``SIGNATURES``: the
    operands, the shapes and the plan's tile before the stream."""
    tc = _build.SIGNATURES["lvc_block_ncl_sr_launch"]
    assert _arity(_source("lvc_block_ncl_tc.cu"),
                  "lvc_block_ncl_sr_launch") == len(tc) == 17
    assert tc == [_build._P] * 8 + [_build._I] * 8 + [_build._P]
