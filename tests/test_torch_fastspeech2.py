"""The port's FastSpeech 2 (``fastdiff_tpu_torch/models/fastspeech2.py``,
``models/transformer.py``, ``ops/pitch.py``, ``ops/cwt.py``) against the JAX
package's on the CPU.

- ``f0_to_coarse`` equal as integers, ``denorm_f0`` and ``cwt_to_f0``
  within 1e-6 relative;
- one transformer layer, with a batch row that is all padding, within 1e-5;
- ``dur_to_mel2ph`` / ``mel2ph_to_dur`` exact;
- the full forward on one set of random weights in JAX's tree (carried
  across by ``fs2_params_from_jax``) at ``tests/test_fastspeech2.py``'s widths
  (hidden 32, 2 + 2 layers) for each pitch type, with energy, with two
  speakers and with a d-vector, in teacher and in inference mode: the mel
  and every pitch / energy output within 1e-4, ``mel2ph`` equal;
- the bridge round trip exact.

The weights are drawn once per variant for the module; JAX's forward runs
op by op (no ``jax.jit``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastdiff_tpu.models import fastspeech2 as jfs2
from fastdiff_tpu.models import transformer as jtr
from fastdiff_tpu.ops import cwt as jcwt
from fastdiff_tpu.ops import pitch as jpitch
from fastdiff_tpu_torch.models import fastspeech2 as fs2
from fastdiff_tpu_torch.models import transformer as tr
from fastdiff_tpu_torch.models.bridge import (fs2_params_from_jax,
                                              fs2_params_to_jax)
from fastdiff_tpu_torch.ops import cwt, pitch

CFG = jfs2.FS2Config(vocab_size=20, hidden=32, enc_layers=2, dec_layers=2,
                     num_heads=2, ffn_hidden=64, ffn_kernel=3, n_mels=8,
                     max_len=40, predictor_hidden=16, use_pitch=True,
                     pitch_type="frame", use_uv=True)
VARIANTS = {
    "frame": {},
    "cwt": {"pitch_type": "cwt"},
    "coarse": {"pitch_type": "coarse", "use_uv": False},
    "energy": {"use_energy": True},
    "two_speakers": {"num_spk": 2},
    "spk_embed": {"use_spk_embed": True},
}
B, T_PH = 2, 7


def _np(x):
    return np.asarray(x)


def _random_tree(jcfg, seed: int = 0):
    """A tree shaped as ``init_fastspeech2``'s (``jax.eval_shape``: nothing
    runs) with numpy leaves: weights N(0, 1/fan_in), tables N(0, 0.3^2),
    biases N(0, 0.05^2), LayerNorm scales 1 + N(0, 0.1^2). Drawing them in
    numpy spares JAX a compile of its random kernels for every shape."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda key: jfs2.init_fastspeech2(key, jcfg),
                            jax.random.PRNGKey(0))

    def leaf(path, sds):
        shape, name = sds.shape, getattr(path[-1], "key", None)
        z = rng.standard_normal(shape)
        if name == "scale":
            z = 1.0 + 0.1 * z
        elif len(shape) == 1:
            z = 0.05 * z
        elif name == "w":
            z = z / np.sqrt(np.prod(shape[:-1]))
        else:
            z = 0.3 * z
        return z.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def jax_params():
    """(config, tree) of each variant, built on first use."""
    cache = {}

    def get(variant):
        if variant not in cache:
            jcfg = dataclasses.replace(CFG, **VARIANTS[variant])
            cache[variant] = (jcfg, _random_tree(jcfg))
        return cache[variant]
    return get


def _port_model(jcfg, tree):
    cfg = fs2.FS2Config(**dataclasses.asdict(jcfg))
    model = fs2.FastSpeech2(cfg)
    model.load_state_dict(fs2_params_from_jax(tree, cfg))
    return model.eval()


def _inputs(jcfg, teacher: bool, seed: int = 0) -> dict:
    """tokens (row 1 padded after 5 phones), per config a speaker id or
    d-vector, and in teacher mode mel2ph from random durations with
    padding frames, normalized f0 / uv, coarse pitch and energy."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(3, jcfg.vocab_size, (B, T_PH))
    tokens[1, 5:] = 0
    out = {"tokens": tokens}
    if jcfg.num_spk > 1:
        out["spk_id"] = np.array([0, 1])
    if jcfg.use_spk_embed:
        out["spk_embed"] = rng.standard_normal(
            (B, jcfg.spk_embed_dim)).astype(np.float32)
    if not teacher:
        return out
    # at most 4 frames a phone and padding frames after each row, within
    # max_len frames, so both modes share JAX's compiled shapes
    dur = rng.integers(1, 5, (B, T_PH)).astype(np.float32) * (tokens > 0)
    t_mel = jcfg.max_len
    out["mel2ph"] = _np(jfs2.dur_to_mel2ph(jnp.asarray(dur), t_mel))
    f0 = np.zeros((B, t_mel), np.float32)
    uv = np.zeros((B, t_mel), np.float32)
    for b in range(B):
        hz = rng.uniform(80, 300, t_mel).astype(np.float32)
        hz[::5] = 0.0
        f0[b], uv[b] = jpitch.norm_interp_f0(hz)
    if jcfg.pitch_type == "coarse":
        out["pitch"] = rng.integers(1, 255, (B, t_mel))
    else:
        out.update(f0=f0, uv=uv)
    if jcfg.use_energy:
        out["energy"] = rng.uniform(0, 4, (B, t_mel)).astype(np.float32)
    return out


# -- pitch and cwt ------------------------------------------------------------

def test_f0_to_coarse_equal():
    rng = np.random.default_rng(0)
    f0 = rng.uniform(0, 1300, 4096).astype(np.float32)
    f0[::7] = 0.0
    ours = pitch.f0_to_coarse_t(torch.from_numpy(f0)).numpy()
    np.testing.assert_array_equal(ours, _np(jpitch.f0_to_coarse_jnp(f0)))
    assert ours.dtype == np.int64
    np.testing.assert_array_equal(pitch.f0_to_coarse(f0),
                                  jpitch.f0_to_coarse(f0))


@pytest.mark.parametrize("pitch_norm", ["log", "standard"])
@pytest.mark.parametrize("with_uv", [False, True])
def test_denorm_f0(pitch_norm, with_uv):
    rng = np.random.default_rng(1)
    f0 = rng.uniform(5, 11, (3, 50)).astype(np.float32)
    if pitch_norm != "log":
        f0 = f0 * 120
    uv = (rng.uniform(size=f0.shape) > 0.7).astype(np.float32) \
        if with_uv else None
    ours = pitch.denorm_f0_t(torch.from_numpy(f0),
                             None if uv is None else torch.from_numpy(uv),
                             pitch_norm).numpy()
    ref = _np(jpitch.denorm_f0_jnp(f0, uv, pitch_norm))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=0)


def test_cwt_to_f0():
    rng = np.random.default_rng(2)
    spec = rng.standard_normal((3, 60, jcwt.N_SCALES)).astype(np.float32)
    mean = rng.uniform(4, 6, 3).astype(np.float32)
    std = rng.uniform(0.1, 0.4, 3).astype(np.float32)
    ours = cwt.cwt_to_f0_t(torch.from_numpy(spec), torch.from_numpy(mean),
                           torch.from_numpy(std)).numpy()
    ref = _np(jcwt.cwt_to_f0_jnp(spec, mean, std))
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=0)
    hz = rng.uniform(90, 250, 80)
    hz[10:20] = 0.0
    for a, b in zip(cwt.f0_to_cwt(hz), jcwt.f0_to_cwt(hz)):
        np.testing.assert_array_equal(a, b)


# -- transformer --------------------------------------------------------------

def test_sinusoidal_positions_equal():
    for length, dim in ((40, 32), (1548, 256), (9, 7)):
        np.testing.assert_array_equal(tr.sinusoidal_positions(length, dim),
                                      jtr.sinusoidal_positions(length, dim))
    # the model keeps one table and slices it: each row is its index's
    model = fs2.FastSpeech2(fs2.FS2Config(**dataclasses.asdict(CFG)))
    for length in (7, CFG.max_len + 9, 3):
        np.testing.assert_array_equal(
            model._positions(length, torch.device("cpu")).numpy(),
            jtr.sinusoidal_positions(length, CFG.hidden))
    assert model._pos_table.shape[0] == CFG.max_len + 9


def test_transformer_layer_with_a_padded_row():
    """CFG's widths and (B, T) = (2, max_len), the forward's shapes."""
    dim, heads = CFG.hidden, CFG.num_heads
    jcfg = dataclasses.replace(CFG, enc_layers=1, dec_layers=0)
    p = _random_tree(jcfg, seed=3)["encoder"][0]
    state = fs2_params_from_jax({"encoder": [p], "decoder": []}, jcfg)
    layer = tr.EncoderLayer(dim, heads, CFG.ffn_hidden, CFG.ffn_kernel)
    layer.load_state_dict({k[len("encoder.0."):]: v
                           for k, v in state.items()})
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, CFG.max_len, dim)).astype(np.float32)
    mask = np.ones((B, CFG.max_len), np.float32)
    mask[0, 23:] = 0.0
    mask[1] = 0.0                                  # all padding
    with torch.no_grad():
        ours = layer(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    ref = _np(jtr.encoder_layer(p, jnp.asarray(x), jnp.asarray(mask), heads))
    assert np.isfinite(ours).all()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    # the all-padding row's attention has uniform weights, as JAX's -1e9 fill
    attn = layer.attn
    with torch.no_grad():
        out = attn(torch.from_numpy(x), torch.from_numpy(mask))
    ref_attn = _np(jtr.self_attention(p["attn"], jnp.asarray(x),
                                      jnp.asarray(mask), heads))
    np.testing.assert_allclose(out.numpy(), ref_attn, rtol=0, atol=1e-5)


# -- length regulation ----------------------------------------------------------

def test_dur_mel2ph_exact():
    rng = np.random.default_rng(5)
    dur = rng.integers(0, 5, (4, 9)).astype(np.float32)
    dur[2, 6:] = 0.0
    t_mel = int(dur.sum(1).max()) + 4
    ours = fs2.dur_to_mel2ph(torch.from_numpy(dur), t_mel)
    np.testing.assert_array_equal(ours.numpy(),
                                  _np(jfs2.dur_to_mel2ph(dur, t_mel)))
    back = fs2.mel2ph_to_dur(ours, 9).numpy()
    np.testing.assert_array_equal(back, _np(jfs2.mel2ph_to_dur(
        jnp.asarray(ours.numpy()), 9)))
    np.testing.assert_array_equal(back, dur)
    np.testing.assert_array_equal(
        fs2.energy_to_coarse(torch.linspace(-1, 5, 97), 256).numpy(),
        _np(jfs2.energy_to_coarse(jnp.linspace(-1, 5, 97), 256)))


# -- the full forward -----------------------------------------------------------

@pytest.mark.parametrize("teacher", [True, False], ids=["teacher", "infer"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_matches_jax(variant, teacher, jax_params):
    jcfg, tree = jax_params(variant)
    inputs = _inputs(jcfg, teacher)
    tokens = inputs.pop("tokens")
    ref = jfs2.fastspeech2_apply(tree, jnp.asarray(tokens), jcfg,
                                 **{k: jnp.asarray(v)
                                    for k, v in inputs.items()})
    with torch.no_grad():
        ours = _port_model(jcfg, tree)(
            torch.from_numpy(tokens),
            **{k: torch.tensor(v) for k, v in inputs.items()})
    assert sorted(k for k, v in ours.items() if v is not None) == \
        sorted(k for k, v in ref.items() if v is not None)
    assert ours["mel"].shape == (B, jcfg.max_len, jcfg.n_mels)
    np.testing.assert_array_equal(ours["mel2ph"].numpy(), _np(ref["mel2ph"]))
    assert int(ours["mel2ph"][1].max()) <= 5        # padded phones: no frames
    for key, value in ref.items():
        if value is None or key == "mel2ph":
            continue
        got = ours[key].numpy()
        assert np.isfinite(got).all(), key
        np.testing.assert_allclose(got, _np(value), rtol=0, atol=1e-4,
                                   err_msg=key)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_bridge_round_trip_exact(variant, jax_params):
    jcfg, tree = jax_params(variant)
    cfg = fs2.FS2Config(**dataclasses.asdict(jcfg))
    state = fs2_params_from_jax(tree, cfg)
    assert sorted(state) == sorted(fs2.FastSpeech2(cfg).state_dict())
    back = fs2_params_to_jax(state, cfg)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    # the port's seed weights load into JAX's tree and back unchanged
    seeded = fs2.FastSpeech2(cfg, seed=3).state_dict()
    again = fs2_params_from_jax(fs2_params_to_jax(seeded, cfg), cfg)
    assert all(torch.equal(again[k], seeded[k]) for k in seeded)
    with pytest.raises(ValueError, match="layers"):
        fs2_params_from_jax(tree, dataclasses.replace(cfg, enc_layers=3))
