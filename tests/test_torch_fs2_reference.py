"""The port's FastSpeech 2 against the benchmark's plain reference
(``portbench/reference/fastspeech2.py``) on the CPU, at hidden 32, 1 + 1
layers, 2 heads, FFN kernel 9, on seeded weights (``portbench/weights.py``,
loaded strictly by the reference's names) and a batch of two sentences, the
second padded.

The output biases of the duration and pitch predictors are set so that the
phones get several frames and the frames are both voiced and unvoiced (seed
weights alone give about one frame a phone). Both sides run the same float32
operations, the port's through its modules (a fused qkv projection, ``nn``
convolutions and LayerNorms, the -1e9 key fill) and the reference's through
``torch.nn.functional``: continuous values and the mel agree within 1e-5
(float32 rounding of a differently ordered sum at these sizes is ~1e-6), the
decisions (durations, mel2ph, pitch bins) exactly. ``work_tts.py``'s FLOP
count is held to PyTorch's FLOP counter over the reference's forward.
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from fastdiff_tpu_torch.models.fastspeech2 import FastSpeech2, FS2Config
from portbench import weights as weightlib
from portbench import work_tts
from portbench.reference import fastspeech2 as ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HP = {"vocab_size": 100, "hidden_size": 32, "enc_layers": 1, "dec_layers": 1,
      "num_heads": 2, "ffn_hidden": 64, "enc_ffn_kernel_size": 9,
      "predictor_hidden": 256, "predictor_kernel": 3,
      "audio_num_mel_bins": 80, "max_frames": 160}
LENGTHS = (20, 13)      # the second row padded to the first's 20 tokens
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch intra-op thread: the suite runs several workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
    weights = weightlib.make(ref.acoustic_shapes(HP), 2 ** 31 + 5, "cpu")
    rng = np.random.default_rng(3)
    tokens = torch.zeros(len(LENGTHS), max(LENGTHS), dtype=torch.long)
    for row, n in enumerate(LENGTHS):
        tokens[row, :n] = torch.from_numpy(rng.integers(1, 100, n))
    # biases: ~4 frames a phone, the median f0 at 200 Hz, half the frames
    # unvoiced
    weights["dur_predictor.out.bias"] = torch.tensor([math.log(5.0)])
    weights["pitch_predictor.out.bias"] = torch.zeros(2)
    with torch.no_grad():
        out = ref.forward(weights, HP, tokens)
        valid = out["mel_mask"] > 0
        weights["pitch_predictor.out.bias"] = torch.stack([
            math.log2(200.0) - out["f0"][valid].median(),
            -out["uv"][valid].median()])
    model = FastSpeech2(FS2Config.from_hparams(HP))
    model.load_state_dict(weights)
    return weights, model, tokens


def test_inference_mode_matches_the_reference(setup):
    weights, model, tokens = setup
    with torch.no_grad():
        ours = model(tokens)
        want = ref.forward(weights, HP, tokens)
    torch.testing.assert_close(ours["dur_pred"], want["d"], rtol=0,
                               atol=ATOL)
    assert torch.equal(ours["mel2ph"], want["mel2ph"])
    frames = (want["mel2ph"] > 0).sum(1)
    assert (frames > 2 * torch.tensor(LENGTHS)).all()   # several a phone
    assert frames.max() < HP["max_frames"]
    for key, other in (("f0_pred", "f0"), ("uv_pred", "uv")):
        torch.testing.assert_close(ours[key], want[other], rtol=0, atol=ATOL)
    valid = want["mel_mask"] > 0
    unvoiced = (want["uv"] > 0) & valid
    assert 0 < int(unvoiced.sum()) < int(valid.sum())
    bins = ref.coarse(ours["f0_denorm"])
    assert torch.equal(bins, want["bins"])
    assert len(set(want["bins"][valid & ~unvoiced].tolist())) > 1
    torch.testing.assert_close(ours["mel"], want["mel"], rtol=0, atol=ATOL)
    assert float(ours["mel"][valid].abs().mean()) > 0.1
    assert not ours["mel"][~valid].any()


def test_teacher_mode_matches_the_reference(setup):
    weights, model, tokens = setup
    rng = np.random.default_rng(4)
    dur = torch.zeros(tokens.shape, dtype=torch.float32)
    for row, n in enumerate(LENGTHS):
        dur[row, :n] = torch.from_numpy(rng.integers(1, 6, n)).float()
    m2p = ref.mel2ph(dur, 96)
    mask = (m2p > 0).float()
    f0 = torch.from_numpy(rng.uniform(6.5, 8.5, m2p.shape)).float()
    uv = torch.from_numpy(rng.uniform(size=m2p.shape) < 0.3).float()
    with torch.no_grad():
        ours = model(tokens, mel2ph=m2p, f0=f0, uv=uv)
        want = ref.forward(weights, HP, tokens, m2p=m2p,
                           bins=ref.coarse(ref.f0_hz(f0, uv, mask)))
    assert torch.equal(ours["mel2ph"], want["mel2ph"])
    torch.testing.assert_close(ours["dur_pred"], want["d"], rtol=0,
                               atol=ATOL)
    assert torch.equal(ref.coarse(ours["f0_denorm"]), want["bins"])
    torch.testing.assert_close(ours["mel"], want["mel"], rtol=0, atol=ATOL)


def test_attention_fills_padded_keys(setup):
    """A padded row's valid queries attend as the row does alone (padded
    keys' logits at -1e9), and the row's padded positions come out of a
    block zeroed. (A block's convolutions do see the padded positions:
    LayerNorm of a zeroed position is its bias, as in the port and JAX.)"""
    weights, _, tokens = setup
    x = torch.randn(2, tokens.shape[1], HP["hidden_size"],
                    generator=torch.Generator().manual_seed(5))
    mask = (tokens > 0).float()
    n = LENGTHS[1]
    with torch.no_grad():
        both = ref.attention(weights, "encoder.0.attn", x, mask, 2,
                             ref.identity)
        alone = ref.attention(weights, "encoder.0.attn", x[1:, :n],
                              mask[1:, :n], 2, ref.identity)
        block = ref.fft_block(weights, "encoder.0", x, mask, 2, ref.identity)
    torch.testing.assert_close(both[1, :n], alone[0], rtol=0, atol=ATOL)
    assert not block[1, n:].any()


def test_flops_match_the_flop_counter(setup):
    weights, _, tokens = setup
    one = tokens[:1]
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        ref.forward(weights, HP, one)
    assert counter.get_total_flops() == work_tts.fastspeech2_flops(
        HP, one.shape[1])


def test_param_shapes_name_both_models():
    hp = dict(HP, inner_channels=8, cond_channels=80, upsample_ratios=[8, 8, 4],
              lvc_layers_each_block=4, lvc_kernel_size=3,
              kpnet_hidden_channels=8, kpnet_conv_size=3,
              diffusion_step_embed_dim_in=16, diffusion_step_embed_dim_mid=32,
              diffusion_step_embed_dim_out=32)
    shapes = ref.param_shapes(hp)
    acoustic, vocoder = ref.split(shapes)
    assert acoustic == ref.acoustic_shapes(hp)
    assert len(acoustic) + len(vocoder) == len(shapes)
    assert {k: tuple(v.shape) for k, v in FastSpeech2(
        FS2Config.from_hparams(hp)).state_dict().items()} == acoustic


def test_reference_loads_no_jax_and_no_program():
    code = ("import sys\n"
            f"sys.path.insert(0, {REPO!r})\n"
            "import portbench.reference.fastspeech2\n"
            "import portbench.drivers.tts\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}\n"
            "             & {'jax', 'jaxlib', 'flax', 'fastdiff_tpu',\n"
            "                'fastdiff_tpu_torch'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
