"""The experiment kernels' plain versions against their Pallas bodies.

K9: ``conv_stage_plain`` and ``lvc_stage_plain`` of
``fastdiff_tpu_torch/scripts/bench_mosaic_micro.py`` against the bodies of
``scripts/bench_mosaic_micro.py`` (``_conv_body``, ``_lvc_body``) run
through ``pl.pallas_call(..., interpret=True)`` built here. K10:
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


def test_conv_stage_plain_matches_pallas_body(script):
    rng = np.random.default_rng(0)
    length, tile = 512, 256
    tap = _bf16(rng, 1, length, script.ROWS)
    w = _bf16(rng, script.LAYERS, script.ROWS, script.C)
    ref = pl.pallas_call(
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
    bf = torch.bfloat16
    out = micro.conv_stage(torch.from_numpy(tap).to(bf),
                           torch.from_numpy(w).to(bf))
    assert out.dtype == bf
    _assert_close(out, ref, ulps=8)


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
    variants; the lines it removes are still there."""
    from fastdiff_tpu_torch.scripts import exp_lvc_stage
    sources = exp_lvc_stage.variant_sources()
    assert set(sources) == {"kernel", "no_repack", "no_mma", "no_store",
                            "io_only", "loads_only"}
    assert "__byte_perm" not in sources["no_repack"]
    assert "mma_bf16(acc" not in sources["no_mma"]
    assert "rows_here" not in sources["no_store"]
    assert all(k in sources["loads_only"] for k in ("bulk_load", "tma_load"))
