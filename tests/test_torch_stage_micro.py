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
