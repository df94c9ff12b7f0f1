"""The tensor-core K5's launch geometry, w_head stream, dispatch and C
entries, checked without a card.

``csrc/lvc_block_ncl_fh.cu`` (K5 at hops that are multiples of 8) takes its
tile, head frames and grid from ``ops/lvc_block_ncl.py:
fh_tile_plan``, whose C entry refuses any other. These tests hold the
Python constants to the source's; hold the walk the kernel does (CTA ``bx``
outputs ``[bx * tile, bx * tile + tile)``, runs the head for frames
``f_lo .. f_lo + npad - 1`` of the extent's samples inside [0, L), and the
LVC over the n8 tiles of those samples) to covering every output once with
every frame it needs; hold the w_head stream (chunk ``c`` of 64 columns,
layer by layer, group by group, the sigmoid half then the tanh half) to
reading every column of w_head once per call into the slab row the LVC
reads; and hold the plan's reckoned w_head bytes, the hop test, the
launch with the plan's numbers and the C entry.
"""

import re

import numpy as np
import pytest
import torch

from fastdiff_tpu_torch.ops import _build
from fastdiff_tpu_torch.ops import lvc_block_ncl as ops
from tests.fake_card import FakeCuda, fake_card

C, LAYERS, K = 32, 4, 192
N = LAYERS * 2 * C * ops.FH_ROWS_P          # w_head columns: 26,624
CASES = [(1, 864, 8), (1, 864, 64), (1, 864, 256), (2, 100, 64),
         (1, 100, 8), (1, 100, 256), (2, 864, 8), (3, 16, 16), (1, 2, 64),
         (4, 864, 8), (4, 864, 64), (2, 864, 256), (1, 256, 8), (1, 256, 64),
         (1, 256, 256), (1, 1, 8), (1, 7, 24), (2, 33, 40)]


def _source() -> str:
    return (_build.CSRC / "lvc_block_ncl_fh.cu").read_text()


def _const(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_python_geometry_matches_the_source():
    src = _source()
    assert _const(src, "KH") == ops.KERNEL_HEAD_K == K
    assert _const(src, "FH_RP") == ops.FH_ROWS_P == 104
    assert _const(src, "FH_GROUP") == ops.FH_GROUP
    assert _const(src, "FH_COLS") == ops.FH_COLS
    assert _const(src, "FH_STAGES") == ops.FH_STAGES
    assert _const(src, "FH_ALIGN") == ops.FH_ALIGN
    assert _const(src, "FH_BAR_BYTES") == ops.FH_BAR_BYTES
    assert _const(src, "FH_NPAD_MAX") == ops.FH_NPAD_MAX
    assert "constexpr int FH_THREADS = THREADS + 32;" in src
    assert ops.FH_THREADS == ops.TC_THREADS + 32 == 288
    assert "constexpr int FH_TROW = KH + 8;" in src
    assert "constexpr int FH_FRAME = 2 * FH_GROUP * FH_RP * 2 + 16;" in src
    assert "constexpr int FH_CHUNK_BYTES = KH * FH_COLS * 2;" in src
    assert ops.FH_CHUNKS == 26 and ops.FH_CHUNK_BYTES == 24_576
    assert ops.W_HEAD_BYTES == K * N * 2 == 10_223_616
    # the same formula as fh_smem_bytes
    assert ("return FH_ALIGN + FH_STAGES * FH_CHUNK_BYTES +\n"
            "         (2 * ext + 2 * YPAD) * ROW * 2 +") in src
    assert ("npad * FH_TROW * 2 + C * WROW * 2 + 9 * C * 4 + FH_BAR_BYTES;"
            in src)


def test_rows_are_conflict_free():
    """ldmatrix reads 8 rows at once: the tap rows (400 bytes) and the slab
    rows (208 bytes) fall in 8 distinct 16-byte bank groups; the head's
    epilogue stores to frames 2t and 2t + 1 of one column land 16 bytes
    apart in banks."""
    for stride in (ops.FH_TROW * 2, ops.FH_ROWS_P * 2):
        assert stride % 16 == 0
        assert len({(r * stride) % 128 for r in range(8)}) == 8
    assert len({(2 * t * ops.FH_FRAME) % 128 for t in range(4)}) == 4


@pytest.mark.parametrize("b,frames,hop", CASES)
def test_walk_covers_every_output_once(b, frames, hop):
    length = frames * hop
    plan = ops.fh_tile_plan(b, frames, hop)
    tile, ext, npad = plan.tile, plan.ext, plan.npad
    assert tile % 8 == 0 and ext == tile + 2 * ops.TC_HALO
    assert npad % 8 == 0 and npad >= ops.fh_frames_max(ext, hop)
    assert npad <= ops.FH_NPAD_MAX     # a warp's two n8 frame tiles
    assert plan.smem_bytes == ops.fh_smem_bytes(ext, npad) \
        <= ops.SMEM_PER_BLOCK
    assert plan.grid_x * tile >= length > (plan.grid_x - 1) * tile
    assert plan.blocks == b * plan.grid_x
    assert plan.waves == -(-plan.blocks // 132)
    hits = np.zeros(length, np.int64)
    for bx in range(plan.grid_x):
        g0 = bx * tile - ops.TC_HALO
        lo, hi = min(max(g0, 0), length), min(g0 + ext, length)
        assert lo < hi         # no CTA lies past the last tile
        hits[bx * tile:min(length, bx * tile + tile)] += 1
        f_lo = lo // hop
        # the head covers every frame the extent's samples need
        assert (hi - 1) // hop - f_lo < npad
        lvc = np.zeros(length, np.int64)
        for j in range((lo - g0) // 8, (hi - g0) // 8):
            samples = g0 + 8 * j + np.arange(8)
            assert (samples // hop == samples[0] // hop).all()
            assert 0 <= samples[0] // hop - f_lo < npad
            lvc[samples] += 1
        assert (lvc[lo:hi] == 1).all() and lvc.sum() == hi - lo
    assert (hits == 1).all()


def _chunk_col(c):
    """The source's chunk_col: w_head's first column of chunk c and its
    half (0 sigmoid, 1 tanh)."""
    groups, chunks = C // ops.FH_GROUP, ops.FH_CHUNKS
    half_chunks = chunks // 2
    i, q, cc = c // (groups * chunks), (c // chunks) % groups, c % chunks
    half = cc // half_chunks
    return ((i * 2 * C + half * C + q * ops.FH_GROUP) * ops.FH_ROWS_P
            + (cc % half_chunks) * ops.FH_COLS), half


def test_stream_reads_every_column_once_into_its_slab_row():
    """The 416 chunks of a call read each w_head column once, and the
    epilogue puts column (layer i, output o, kern row r) of group q into slab
    row o - 8q (sigmoid) or 8 + o - C - 8q (tanh), kern row r."""
    groups = C // ops.FH_GROUP
    total = LAYERS * groups * ops.FH_CHUNKS
    assert total * ops.FH_CHUNK_BYTES == ops.W_HEAD_BYTES
    seen = np.zeros(N, np.int64)
    for c in range(total):
        col0, half = _chunk_col(c)
        i, q = c // (groups * ops.FH_CHUNKS), (c // ops.FH_CHUNKS) % groups
        cc = c % ops.FH_CHUNKS
        for m in range(ops.FH_COLS):
            col = col0 + m
            seen[col] += 1
            # the source's slab index of chunk column m
            local = (cc % (ops.FH_CHUNKS // 2)) * ops.FH_COLS + m
            row, kr = local // ops.FH_ROWS_P + ops.FH_GROUP * half, \
                local % ops.FH_ROWS_P
            li, rest = divmod(col, 2 * C * ops.FH_ROWS_P)
            o, r = divmod(rest, ops.FH_ROWS_P)
            assert (li, r) == (i, kr)
            assert o == (q * ops.FH_GROUP + row if row < ops.FH_GROUP
                         else C + q * ops.FH_GROUP + row - ops.FH_GROUP)
    assert (seen == 1).all()


def test_plan_at_the_10s_shapes():
    """The numbers the kernel's header quotes, at 864 frames on 132 SMs:
    hop 8 at b 1 fills the card (124 CTAs in one wave)."""
    plans = {hop: ops.fh_tile_plan(1, 864, hop) for hop in (8, 64, 256)}
    assert {hop: (p.tile, p.blocks, p.waves, p.npad)
            for hop, p in plans.items()} == {
        8: (56, 124, 1, 24), 64: (424, 131, 1, 16), 256: (424, 522, 4, 8)}
    assert plans[8].blocks >= 0.9 * 132
    # the reckoned w_head bytes: every CTA reads all of w_head from L2
    w_bytes = 192 * 4 * 64 * 104 * 2
    for hop, blocks in ((8, 124), (64, 131), (256, 522)):
        assert plans[hop].l2_bytes == blocks * w_bytes
    assert plans[8].l2_bytes == 1_267_728_384


def test_plan_minimises_waves_times_extent():
    for b, frames, hop in [(1, 864, 8), (1, 864, 64), (2, 100, 64)]:
        plan = ops.fh_tile_plan(b, frames, hop)
        length = frames * hop
        for tile in range(8, 2048, 8):
            ext = tile + 2 * ops.TC_HALO
            npad = -(-ops.fh_frames_max(ext, hop) // 8) * 8
            if ops.fh_smem_bytes(ext, npad) > ops.SMEM_PER_BLOCK:
                break
            if npad > ops.FH_NPAD_MAX:
                break
            grid_x = -(-length // tile)
            waves = -(-(b * grid_x) // 132)
            assert plan.waves * plan.ext <= waves * ext


@pytest.mark.parametrize("b,frames,hop", [(0, 8, 8), (1, 8, 12), (1, 8, 4),
                                          (1, 0, 8)])
def test_plan_refuses(b, frames, hop):
    with pytest.raises(ValueError):
        ops.fh_tile_plan(b, frames, hop)


@pytest.mark.parametrize("hop,final,tensor_cores", [
    (8, False, True), (64, False, True), (256, True, True),
    (12, False, False), (4, True, False)])
def test_hop_picks_the_kernel(monkeypatch, hop, final, tensor_cores):
    """A CUDA tensor reaches the tensor-core entry with the plan's numbers
    when ``tensor_core_hop(hop)`` (counted apart with the epilogue), else
    raises naming the hop before any launch."""
    lib = fake_card(monkeypatch, ops)
    b, frames = 1, 16
    x = FakeCuda((b, C, frames * hop))
    tap_c = FakeCuda((b, frames, K))
    w_head = FakeCuda((K, N))
    b_head = FakeCuda((N,), torch.float32)
    wstack_t = FakeCuda((LAYERS, C, 3 * C + 1))
    final_wb = FakeCuda((8, C)) if final else None
    before = dict(ops.LAUNCHES)
    if not tensor_cores:
        with pytest.raises(ValueError, match=f"hop {hop}"):
            ops.lvc_block_ncl_fh(x, x, tap_c, w_head, b_head, wstack_t, hop,
                                 final_wb)
        assert lib.calls == [] and ops.LAUNCHES == before
        return
    ops.lvc_block_ncl_fh(x, x, tap_c, w_head, b_head, wstack_t, hop,
                         final_wb)
    (name, args), = lib.calls
    c_args = ops.fh_tile_plan(b, frames, hop, 132).c_args
    assert name == "lvc_block_ncl_fh_launch"
    assert args[9:] == (b, C, frames * hop, frames, hop, K, ops.FH_ROWS_P,
                        LAYERS, *c_args, 0)
    key = "lvc_block_ncl_fh_final" if final else "lvc_block_ncl_fh"
    assert ops.LAUNCHES == dict(before, **{key: before[key] + 1})


def test_entries_take_the_plan():
    """The tensor-core entry takes the operands, the shapes and the plan's
    numbers before the stream, as its definition in the source does."""
    tc = _build.SIGNATURES["lvc_block_ncl_fh_launch"]
    n = len(ops.fh_tile_plan(1, 864, 8).c_args)
    assert tc == [_build._P] * 9 + [_build._I] * (8 + n) + [_build._P]
    m = re.search(r'extern "C" int lvc_block_ncl_fh_launch\(([^)]*)\)',
                  _source())
    assert len(m.group(1).split(",")) == len(tc)
    assert "wmma" not in _source()
