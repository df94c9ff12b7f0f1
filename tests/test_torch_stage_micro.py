"""The experiment kernels' plain versions against their Pallas bodies.

K9: ``conv_stage_plain`` and ``lvc_stage_plain`` of
``fastdiff_tpu_torch/scripts/bench_mosaic_micro.py`` against the bodies of
``scripts/bench_mosaic_micro.py`` (``_conv_body``, ``_lvc_body``) run
through ``pl.pallas_call(..., interpret=True)`` built here, and a model of
the tensor-core ``conv_stage`` kernel (its walk, each piece's span, each
warp's repack and arithmetic) against both. K10:
``taug_head_variant_plain`` against ``taug_head_matmul_5d(...,
interpret=True)``. bf16 in, f32 sums, one bf16 rounding per stored value on
both sides: outputs within one bf16 ulp (2^-8 relative) where a sum in
another order flips a rounding, and the chained conv within 4 (2^-5 of the
largest value), a flip in one layer reaching the next.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from fastdiff_tpu.ops.lvc_block_pallas import taug_head_matmul_5d
from fastdiff_tpu_torch.ops import lvc_head
from fastdiff_tpu_torch.scripts import bench_mosaic_micro as micro
from fastdiff_tpu_torch.scripts import exp_r4b

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the jax.config values the script sets when it is imported
_SCRIPT_CONFIG = ("jax_compilation_cache_dir",
                  "jax_persistent_cache_min_entry_size_bytes",
                  "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture(scope="module")
def script():
    """``scripts/bench_mosaic_micro.py`` imported by path, the jax.config
    values it sets put back afterwards."""
    saved = {k: getattr(jax.config, k) for k in _SCRIPT_CONFIG}
    try:
        spec = importlib.util.spec_from_file_location(
            "bench_mosaic_micro_jax",
            os.path.join(REPO, "scripts", "bench_mosaic_micro.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        yield module
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)


def _bf16(rng, *shape, scale=0.1):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _assert_close(got: torch.Tensor, want, ulps: float):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ulps * 2.0 ** -8 * np.abs(want).max())


def _conv_pallas(script, tap, w, tile=256):
    """JAX's ``_conv_body`` over (1, length) in tiles of ``tile`` rows."""
    length = tap.shape[1]
    return pl.pallas_call(
        functools.partial(script._conv_body, layers=script.LAYERS),
        grid=(1, length // tile),
        in_specs=[pl.BlockSpec((1, tile, script.ROWS),
                               lambda bi, ti: (bi, ti, 0)),
                  pl.BlockSpec((script.LAYERS, script.ROWS, script.C),
                               lambda bi, ti: (0, 0, 0))],
        out_specs=pl.BlockSpec((1, tile, script.C),
                               lambda bi, ti: (bi, ti, 0)),
        out_shape=jax.ShapeDtypeStruct((1, length, script.C), jnp.bfloat16),
        interpret=True,
    )(jnp.asarray(tap, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))


def test_conv_stage_plain_matches_pallas_body(script):
    rng = np.random.default_rng(0)
    length = 512
    tap = _bf16(rng, 1, length, script.ROWS)
    w = _bf16(rng, script.LAYERS, script.ROWS, script.C)
    ref = _conv_pallas(script, tap, w)
    bf = torch.bfloat16
    out = micro.conv_stage(torch.from_numpy(tap).to(bf),
                           torch.from_numpy(w).to(bf))
    assert out.dtype == bf
    _assert_close(out, ref, ulps=8)


# ---- a model of the tensor-core conv_stage kernel -------------------------
_PIECE, _STAGE = micro.LVC_PIECE_ROWS, micro._TAP_STAGE_BYTES
_ROW_BYTES = 2 * micro.ROWS


def _conv_walk(rows: int, tile_s: int, grid: int) -> dict:
    """``for_each_row_piece``: block -> its pieces (first row, rows), units
    of tile_s rows dealt round robin, each cut into pieces of 256."""
    units = -(-rows // tile_s)
    walk = {}
    for block in range(grid):
        walk[block] = []
        for u in range(block, units, grid):
            end = min(rows, (u + 1) * tile_s)
            walk[block] += [(r0, min(_PIECE, end - r0))
                            for r0 in range(u * tile_s, end, _PIECE)]
    return walk


def _stage_piece(raw: np.ndarray, row0: int, n: int) -> np.ndarray:
    """``load_tap_span``: a ring stage (bytes of garbage, 0xFF: bf16 NaN)
    holding the 16-byte-aligned span of tap's bytes ``raw`` that covers
    rows [row0, row0 + n), tap's last bytes past its last 16-byte boundary
    copied apart."""
    stage = np.full(_STAGE, 0xFF, np.uint8)
    total = raw.size
    total16 = total & ~15
    a0 = (row0 * _ROW_BYTES) & ~15
    a1 = ((row0 + n) * _ROW_BYTES + 15) & ~15
    if a1 > total:
        stage[total16 - a0:total - a0] = raw[total16:total]
        a1 = total16
    assert a1 - a0 <= _STAGE
    stage[:a1 - a0] = raw[a0:a1]
    return stage


def _repack(stage: np.ndarray, off0: int, r_begin: int) -> torch.Tensor:
    """``repack_rows``: a warp's 32 rows as (32, 112) bf16, columns 97..
    zero, each 16-byte chunk taken from two aligned chunks by the kernel's
    word selects and byte permutes."""
    words = stage.view(np.uint32)
    row = np.arange(32)[:, None]
    c = np.arange(13)[None, :]
    p = off0 + (r_begin + row) * _ROW_BYTES + 16 * c          # (32, 13)
    x = words[(p & ~15)[..., None] // 4 + np.arange(8)]      # lo, hi
    sh = (p & 15)[..., None]
    x = np.where(sh & 8, np.concatenate([x[..., 2:], x[..., 6:]], -1), x)
    x = np.where(sh & 4, np.concatenate([x[..., 1:], x[..., 7:]], -1), x)
    w = np.where(sh & 2, (x[..., :4] >> 16) | (x[..., 1:5] << 16),
                 x[..., :4]).astype(np.uint32)
    w[:, 12, 0] &= 0xFFFF                                     # tap 96 only
    w[:, 12, 1:] = 0
    a = np.zeros((32, 14, 4), np.uint32)
    a[:, :13] = w
    return torch.from_numpy(a.view(np.int16).reshape(32, 112).copy()).view(
        torch.bfloat16)


def _warp_arithmetic(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One warp's layer chain, (32, 112) bf16 -> (32, 32) bf16: layer 0
    in 7 k16 steps against W_0 padded with zero rows 97..111; layers 1-3
    started from W_i[96] in f32 and summed over 6 k16 steps, the same two
    k16 steps of bf16(y) against W_i's rows 0-31, 32-63 and 64-95; one bf16
    rounding after each layer."""
    w = w.float()
    w0 = torch.cat([w[0], w.new_zeros(112 - micro.ROWS, micro.C)])
    acc = torch.zeros(32, micro.C)
    for kt in range(7):
        acc = acc + a[:, 16 * kt:16 * kt + 16].float() @ w0[16 * kt:16 * kt
                                                            + 16]
    for i in range(1, micro.LAYERS):
        y = acc.to(torch.bfloat16).float()
        acc = w[i, micro.ROWS - 1].expand(32, micro.C).clone()
        for kt in range(6):
            kk = kt % 2
            acc = acc + y[:, 16 * kk:16 * kk + 16] @ w[i, 16 * kt:16 * kt + 16]
    return acc.to(torch.bfloat16)


def _conv_kernel_model(tap: torch.Tensor, w: torch.Tensor, tile_s: int,
                       grid: int) -> torch.Tensor:
    """``conv_stage_kernel`` in Python: every block's pieces, each piece's
    stage, each warp's repack, arithmetic and masked store. Asserts that
    every row is stored exactly once."""
    b, e, _ = tap.shape
    rows = b * e
    raw = tap.contiguous().view(torch.int16).numpy().view(np.uint8).ravel()
    out = torch.zeros(rows, micro.C, dtype=torch.bfloat16)
    stored = np.zeros(rows, np.int64)
    for pieces in _conv_walk(rows, tile_s, grid).values():
        for row0, n in pieces:
            stage = _stage_piece(raw, row0, n)
            off0 = (row0 * _ROW_BYTES) & 15
            for r_begin in range(0, n, 32):
                y = _warp_arithmetic(_repack(stage, off0, r_begin), w)
                mine = min(32, n - r_begin)
                out[row0 + r_begin:row0 + r_begin + mine] = y[:mine]
                stored[row0 + r_begin:row0 + r_begin + mine] += 1
    assert (stored == 1).all()
    return out.reshape(b, e, micro.C)


def test_conv_kernel_model_matches_plain_and_pallas(script):
    """The kernel's arithmetic, fed by its walk, spans and repack: within 4
    bf16 ulps of the largest output of ``conv_stage_plain`` (f32 sums in
    k16 steps, one rounding flip per layer at most) and 8 of JAX's
    ``_conv_body``."""
    rng = np.random.default_rng(5)
    tap = _bf16(rng, 1, 512, script.ROWS)
    w = _bf16(rng, script.LAYERS, script.ROWS, script.C)
    bf = torch.bfloat16
    tap_t, w_t = torch.from_numpy(tap).to(bf), torch.from_numpy(w).to(bf)
    model = _conv_kernel_model(tap_t, w_t, tile_s=256, grid=2)
    _assert_close(model, micro.conv_stage_plain(tap_t, w_t).float(), ulps=4)
    _assert_close(model, _conv_pallas(script, tap, w), ulps=8)


@pytest.mark.parametrize("b,e,tile_s,grid", [
    (2, 1000, 256, 8),      # a piece crosses the batch boundary
    (2, 1000, 2048, 1),     # one unit: every piece, the last one short
    (3, 77, 100, 3),        # pieces shorter than a warp's 32 rows
])
def test_conv_kernel_model_ragged(b, e, tile_s, grid):
    """The model at ragged shapes (E no multiple of 8 or of 256, rows that
    end inside tap's last 16 bytes) against ``conv_stage_plain``."""
    rng = np.random.default_rng(6)
    bf = torch.bfloat16
    tap = torch.from_numpy(_bf16(rng, b, e, micro.ROWS)).to(bf)
    w = torch.from_numpy(_bf16(rng, micro.LAYERS, micro.ROWS, micro.C)).to(bf)
    model = _conv_kernel_model(tap, w, tile_s, grid)
    _assert_close(model, micro.conv_stage_plain(tap, w).float(), ulps=4)


@pytest.mark.parametrize("b,e,tile_s,sms", [
    (1, 221_184, 256, 132), (1, 221_184, 2048, 132), (1, 221_184, 8192, 132),
    (2, 1000, 256, 132), (2, 1000, 4096, 132), (3, 777, 100, 5),
    (1, 5, 1, 132), (5, 999, 257, 7),
])
def test_conv_stage_walk(b, e, tile_s, sms):
    """The kernel's walk covers each of the B * E rows exactly once, in
    pieces of at most 256 rows; each piece's span and the repack's overread
    (up to 32 bytes past the last repacked row's last chunk) fit one ring
    stage."""
    rows = b * e
    grid = micro.conv_stage_grid(rows, tile_s, sms)
    assert 1 <= grid <= sms and grid <= -(-rows // tile_s)
    covered = np.zeros(rows, np.int64)
    crossing = False
    for pieces in _conv_walk(rows, tile_s, grid).values():
        for row0, n in pieces:
            assert 1 <= n <= _PIECE
            covered[row0:row0 + n] += 1
            crossing |= row0 // e != (row0 + n - 1) // e
            a0 = (row0 * _ROW_BYTES) & ~15
            a1 = ((row0 + n) * _ROW_BYTES + 15) & ~15
            off0 = (row0 * _ROW_BYTES) & 15
            last = -(-n // 32) * 32 - 1   # the last row a warp repacks
            overread = ((off0 + last * _ROW_BYTES + 16 * 12) & ~15) + 32
            assert max(a1 - a0, overread) <= _STAGE
    assert (covered == 1).all()
    if (b, e, tile_s) == (2, 1000, 256):
        assert crossing


def test_conv_geometry_matches_the_source():
    """The geometry ``conv_stage`` passes to ``conv_stage_launch`` (ring
    stages, shared-memory bytes) is the one ``csrc/stage_micro.cu``
    declares, which the entry point checks; the kernel runs on the tensor
    cores, with lvc_stage's pieces, copy and repack, and the CUDA-core body
    is gone."""
    from fastdiff_tpu_torch.ops import _build
    from fastdiff_tpu_torch.scripts import exp_lvc_stage
    import re
    src = (_build.CSRC / "stage_micro.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)
                   .group(1))

    assert const("CONV_STAGES") == micro.CONV_STAGES == 2
    assert const("WROW") == micro._W_ROW
    assert "constexpr int W_ROWS = LVC_KPAD + (NL - 1) * (R - 1);" in src
    assert ("constexpr int CONV_W_BYTES = W_ROWS * WROW * 2 + (NL - 1) * CO "
            "* 4;") in src
    assert re.search(r"constexpr int CONV_SMEM = CONV_W_BYTES \+ CONV_STAGES "
                     r"\* TAP_STAGE \+\s+LVC_WARPS \* WARP_BUF \+ 16 \* "
                     r"CONV_STAGES;", src)
    # two stages fit beside the weights, a third would not
    assert micro.CONV_SMEM_BYTES == 193_440 <= 232_448
    assert micro.CONV_SMEM_BYTES + _STAGE + 16 > 232_448
    # 80-byte weight rows: ldmatrix.trans's 8 rows hit 8 bank groups; the
    # 64-byte staging rows, chunk ^ (row / 2) & 3: stmatrix's 8 rows and the
    # stores' 2 rows x 4 chunks per 8 lanes too
    assert len({r * micro._W_ROW * 2 // 16 % 8 for r in range(8)}) == 8
    swz = lambda r, c: (4 * r + (c ^ ((r >> 1) & 3))) % 8
    assert all(len({swz(r, c) for r in range(r0, r0 + 8)}) == 8
               for r0 in range(0, 32, 8) for c in range(4))
    assert all(len({swz(r0 + q // 4, q % 4) for q in range(8)}) == 8
               for r0 in range(0, 32, 2))
    body = exp_lvc_stage.kernel_body(src, "conv_stage_kernel")
    assert "mma.sync.aligned.m16n8k16" in src and "mma_bf16(acc" in body
    for call in ("load_tap_span(", "repack_rows(", "ldsm_x4(",
                 "ldsm_x4_trans(", "stsm_x4("):
        assert call in body
    # the CUDA-core kernel (f32 accumulators, one row per thread) is gone
    assert "float acc[CO]" not in src
    assert "for (int r = 0; r < R; ++r)" not in src
    assert _build.SIGNATURES["conv_stage_launch"] == (
        [_build._P] * 3 + [_build._I] * 7 + [_build._P])


@pytest.mark.parametrize("what", ["tile_s", "rows", "w_rows", "w_layers",
                                  "w_cols", "tap_dims"])
def test_conv_stage_refuses(what):
    """The wrapper refuses, on any device, a tile_s below 1, a tap row
    count other than 97 and a w other than (4, 97, 32)."""
    tap = torch.zeros(1, 64, micro.ROWS, dtype=torch.bfloat16)
    w = torch.zeros(micro.LAYERS, micro.ROWS, micro.C, dtype=torch.bfloat16)
    tile_s = 256
    if what == "tile_s":
        tile_s = 0
    elif what == "rows":
        tap = tap[..., :96]
    elif what == "w_rows":
        w = w[:, :96]
    elif what == "w_layers":
        w = w[:3]
    elif what == "w_cols":
        w = w[..., :16]
    else:
        tap = tap[0]
    with pytest.raises(ValueError, match="conv_stage"):
        micro.conv_stage(tap, w, tile_s)


def test_conv_stage_grid():
    """One block per SM, fewer when there are fewer units of tile_s
    rows."""
    assert micro.conv_stage_grid(221_184, 256, 132) == 132
    assert micro.conv_stage_grid(221_184, 2048, 132) == 108
    assert micro.conv_stage_grid(221_184, 8192, 132) == 27
    assert micro.conv_stage_grid(2000, 256, 132) == 8
    assert micro.CONV_TILE_S in micro.CONV_TILES


@pytest.mark.parametrize("variant", ["batched", "unroll"])
def test_lvc_stage_plain_matches_pallas_body(script, variant):
    rng = np.random.default_rng(1)
    hop, frames, tf = 16, 8, 4
    tap = _bf16(rng, 1, frames * hop, script.ROWS)
    kern = _bf16(rng, 1, frames, script.ROWS, script.C2)
    ref = pl.pallas_call(
        functools.partial(script._lvc_body, hop=hop, variant=variant),
        grid=(1, frames // tf),
        in_specs=[pl.BlockSpec((1, tf * hop, script.ROWS),
                               lambda bi, ti: (bi, ti, 0)),
                  pl.BlockSpec((1, tf, script.ROWS, script.C2),
                               lambda bi, ti: (bi, ti, 0, 0))],
        out_specs=pl.BlockSpec((1, tf * hop, script.C2),
                               lambda bi, ti: (bi, ti, 0)),
        out_shape=jax.ShapeDtypeStruct((1, frames * hop, script.C2),
                                       jnp.bfloat16),
        interpret=True,
    )(jnp.asarray(tap, jnp.bfloat16), jnp.asarray(kern, jnp.bfloat16))
    bf = torch.bfloat16
    out = micro.lvc_stage(torch.from_numpy(tap).to(bf),
                          torch.from_numpy(kern).to(bf), hop)
    _assert_close(out, ref, ulps=1)


def test_gate_stage_matches_script(script):
    z = _bf16(np.random.default_rng(2), 1, 64, micro.C2, scale=2.0)
    out = micro.gate_stage(torch.from_numpy(z))
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(script.gate_stage(jnp.asarray(z))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("order", ["m_outer", "w_res"])
def test_taug_head_variant_plain_matches_pallas(order):
    """K10's plain version against JAX's head kernel at rows 128 (its lane
    padding), the output read as (M, layers, cout, rows)."""
    rng = np.random.default_rng(3)
    m, k, layers, cout, rows = 24, 32, 2, 16, 128
    tap = _bf16(rng, m, k, scale=1.0)
    w = _bf16(rng, k, layers * cout * rows, scale=0.05)
    b = _bf16(rng, layers * cout * rows)
    ref = taug_head_matmul_5d(jnp.asarray(tap, jnp.bfloat16),
                              jnp.asarray(w, jnp.bfloat16), jnp.asarray(b),
                              layers, cout, rows, interpret=True)
    bf = torch.bfloat16
    out = lvc_head.taug_head_variant(
        torch.from_numpy(tap).to(bf), torch.from_numpy(w).to(bf),
        torch.from_numpy(b), order=order, m_tile=8)
    _assert_close(out.reshape(m, layers, cout, rows), ref, ulps=1)


def test_experiments_on_cpu():
    """The scripts' entry points run their plain versions on the CPU (no
    times), report errors of zero against themselves, and refuse to time
    without a card."""
    report = micro.run("cpu", length=2048)
    for name in ("conv_stage", "lvc_stage"):
        assert all(r["max_abs_err"] == 0.0 for r in report[name]["rows"])
        assert report[name]["bound_by"] == "bytes"
    rb = exp_r4b.exp_b("cpu")
    assert [v["order"] for v in rb["variants"]] == [
        o for _, o, _ in exp_r4b.VARIANTS]
    assert all(v["max_abs_err"] == 0.0 for v in rb["variants"])
    with pytest.raises(RuntimeError, match="CUDA"):
        exp_r4b.exp_d("cpu")
    with pytest.raises(ValueError, match="order"):
        lvc_head.taug_head_variant(torch.zeros(8, 16), torch.zeros(16, 8),
                                   torch.zeros(8), order="sideways")


def test_lvc_geometry_matches_the_source():
    """The geometry ``lvc_stage`` passes to ``lvc_stage_launch`` (padded K,
    ring stages, shared-memory bytes) is the one ``csrc/stage_micro.cu``
    declares, which the entry point checks."""
    from fastdiff_tpu_torch.ops import _build
    import re
    src = (_build.CSRC / "stage_micro.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)
                   .group(1))

    assert const("LVC_KPAD") == micro.LVC_K_PAD == 112
    assert const("LVC_STAGES") == micro.LVC_STAGES
    assert const("LVC_PIECE") == micro.LVC_PIECE_ROWS
    assert const("LVC_WARPS") == micro.LVC_WARPS
    assert const("TAP_STAGE") == micro._TAP_STAGE_BYTES
    assert const("AROW") == micro._A_ROW
    assert const("LVC_ALIGN") == micro._SMEM_ALIGN
    assert re.search(r"constexpr int LVC_SMEM = LVC_ALIGN \+ LVC_STAGES \* "
                     r"\(KERN_STAGE \+ TAP_STAGE\) \+\s+LVC_WARPS \* "
                     r"WARP_BUF \+ 16 \* LVC_STAGES;", src)
    assert micro.LVC_SMEM_BYTES == 190_752 <= 232_448
    # a piece's tap span, 16-byte aligned at both ends, and the repack's
    # 32-byte overread fit a stage
    span = -(-(14 + 2 * micro.ROWS * micro.LVC_PIECE_ROWS) // 16) * 16
    assert span + 32 <= micro._TAP_STAGE_BYTES
    assert "mma.sync.aligned.m16n8k16" in src and "cp.async.bulk" in src
    assert "float acc[ZO]" not in src     # the CUDA-core kernel is gone
    assert _build.SIGNATURES["lvc_stage_launch"][9:13] == [_build._I] * 4


@pytest.mark.parametrize("what", ["tf", "rows", "frames", "hop"])
def test_lvc_stage_refuses(what):
    """The wrapper refuses, on any device, a tf below 1, a tap or kern row
    count other than 97, and F * hop != L."""
    hop, frames, tf = 16, 4, 1
    tap = torch.zeros(1, frames * hop, micro.ROWS, dtype=torch.bfloat16)
    kern = torch.zeros(1, frames, micro.ROWS, micro.C2, dtype=torch.bfloat16)
    if what == "tf":
        tf = 0
    elif what == "rows":
        tap, kern = tap[..., :96], kern[:, :, :96]
    elif what == "frames":
        kern = kern[:, :3]
    else:
        hop = 8
    with pytest.raises(ValueError, match="lvc_stage"):
        micro.lvc_stage(tap, kern, hop, tf)


def test_lvc_stage_grid():
    """One block per SM, fewer when there are fewer units of tf frames."""
    assert micro.lvc_stage_grid(1, 864, 1, 132) == 132
    assert micro.lvc_stage_grid(1, 864, 8, 132) == 108
    assert micro.lvc_stage_grid(2, 864, 8, 132) == 132
    assert micro.lvc_stage_grid(1, 5, 2, 132) == 3


def test_lvc_experiment_variants_apply():
    """``scripts/exp_lvc_stage.py`` edits the kernel's source into its
    variants; the lines it removes are still there, and each variant
    removes them from ``lvc_stage_kernel`` alone."""
    from fastdiff_tpu_torch.scripts import exp_lvc_stage
    sources = exp_lvc_stage.variant_sources()
    assert set(sources) == {"kernel", "no_repack", "no_mma", "no_store",
                            "io_only", "loads_only"}
    body = {name: exp_lvc_stage.kernel_body(text, "lvc_stage_kernel")
            for name, text in sources.items()}
    conv = {exp_lvc_stage.kernel_body(text, "conv_stage_kernel")
            for text in sources.values()}
    assert len(conv) == 1                  # conv_stage_kernel untouched
    assert "repack_rows(" in body["kernel"]
    assert "repack_rows(" not in body["no_repack"]
    assert "mma_bf16(acc" not in body["no_mma"]
    assert "rows_here" not in body["no_store"]
    assert all(k in body["loads_only"] for k in ("load_tap_span", "tma_load"))


def test_conv_experiment_variants_apply():
    """The same script's variants of ``conv_stage_kernel``: each removes
    its part (repack, layer 0, layers 1-3, stores) and leaves
    ``lvc_stage_kernel`` as it is."""
    from fastdiff_tpu_torch.scripts import exp_lvc_stage
    sources = exp_lvc_stage.variant_sources("conv")
    assert set(sources) == {"kernel", "no_repack", "no_layer0", "no_chain",
                            "no_mma", "no_store", "io_only", "loads_only"}
    body = {name: exp_lvc_stage.kernel_body(text, "conv_stage_kernel")
            for name, text in sources.items()}
    assert len({exp_lvc_stage.kernel_body(text, "lvc_stage_kernel")
                for text in sources.values()}) == 1
    assert body["kernel"].count("mma_bf16(acc") == 4
    assert "repack_rows(" not in body["no_repack"]
    assert "mbar_arrive(empty" in body["no_repack"]  # still released
    assert body["no_layer0"].count("mma_bf16(acc") == 2
    assert "ldsm_x4(a[mt]" not in body["no_layer0"]
    assert "= w_one + (layer - 1)" in body["no_layer0"]
    assert body["no_chain"].count("mma_bf16(acc") == 2
    assert "ldsm_x4(a[mt]" in body["no_chain"]
    assert "= w_one + (layer - 1)" not in body["no_chain"]
    assert "mma_bf16(acc" not in body["no_mma"]
    assert "stsm_x4(" in body["no_store"] and "mine" not in body["no_store"]
    assert all(k in body["loads_only"] for k in ("load_tap_span",
                                                 "mbar_arrive(empty"))
    assert not any(k in body["loads_only"] for k in ("repack_rows(",
                                                     "mma_bf16(", "mine"))
