"""The port's TTS serving path against the JAX package's on the CPU.

Both packages read ``fastdiff_tpu/configs/fs2_ljspeech.yaml`` with the same
small overrides (FastSpeech 2 at hidden 32, 2 + 2 layers, ``max_frames``
128; the FastDiff vocoder at C = 4, 2 LVC layers, f32, N = 4) and a phone
set written from the ``en`` processor's output, as the binarizer writes
it. ``FastSpeech2Task.infer_to_wav`` of each runs one sentence through one
set of random FastSpeech 2 weights in JAX's tree (carried across by
``fs2_params_from_jax``) into one set of random fused FastDiff weights in
JAX's tree (carried across by ``params_from_jax``), with JAX's draws
injected into the port's sampler: the mel within 1e-4 with the same frame
count, the wav within 1e-3. The weights are drawn in numpy, which spares
JAX a compile of its initializers for every shape. Also: the task builds its vocoder
from the registry once and keeps it, the ``demo_tts`` script
(``TTSPipeline`` with ``NpyMelSource``) writes peak-normalized wavs of
frames * hop samples, the text
front end gives JAX's token ids, and what the TTS path still refuses
(speaker embeddings) raises.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from fastdiff_tpu.config import ModelConfig as JaxModelConfig
from fastdiff_tpu.models.fastdiff import fuse_weight_norm, init_fastdiff
from fastdiff_tpu.text.encoder import build_token_encoder as jax_encoder
from fastdiff_tpu.training.tts_task import FastSpeech2Task as JaxTask
from fastdiff_tpu.tts.infer import BaseTTSInfer as JaxBaseTTSInfer
from fastdiff_tpu.utils import hparams as jax_hparams
from fastdiff_tpu.vocoders.fastdiff_vocoder import FastDiff as JaxFastDiff
from fastdiff_tpu_torch.config import ModelConfig
from fastdiff_tpu_torch.data.dataset import resolve_class
from fastdiff_tpu_torch.data.tts_binarizer import TTSBinarizer
from fastdiff_tpu_torch.models.bridge import (fs2_params_from_jax,
                                              params_from_jax)
from fastdiff_tpu_torch.scripts import demo_tts
from fastdiff_tpu_torch.text.encoder import build_token_encoder
from fastdiff_tpu_torch.text.processors import get_txt_processor_cls
from fastdiff_tpu_torch.training.tts_task import FastSpeech2Task
from fastdiff_tpu_torch.tts.infer import BaseTTSInfer, NpyMelSource
from fastdiff_tpu_torch.utils import audio_io
from fastdiff_tpu_torch.utils.hparams import set_hparams
from fastdiff_tpu_torch.vocoders.fastdiff_vocoder import FastDiffVocoder
from tests.test_torch_fastspeech2 import _random_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "fastdiff_tpu", "configs", "fs2_ljspeech.yaml")
SMALL = ("hidden_size=32,enc_layers=2,dec_layers=2,ffn_hidden=64,"
         "enc_ffn_kernel_size=3,max_frames=128,"
         "N=4,inner_channels=4,lvc_layers_each_block=2,"
         "kpnet_hidden_channels=8,diffusion_step_embed_dim_in=16,"
         "diffusion_step_embed_dim_mid=32,diffusion_step_embed_dim_out=32,"
         "compute_dtype=float32")
SENTENCES = ["Printing, in the only sense with which we are at present "
             "concerned.", "It is 42 degrees."]
SEED = 1234


class _Recording:
    """A vocoder that records the mels it is given."""

    def __init__(self, vocoder):
        self.vocoder, self.mels = vocoder, []

    def spec2wav(self, mel):
        self.mels.append(np.array(mel))
        return self.vocoder.spec2wav(mel)


def _jax_draws(index: int, length: int, n_steps: int = 4):
    """The draws of the JAX vocoder's ``index``-th ``spec2wav``: its key
    is split once per call, and its sampler splits that key for x_T and the
    step keys (``fastdiff_tpu/diffusion/sampler.py``)."""
    key = jax.random.PRNGKey(SEED)
    for _ in range(index + 1):
        key, sub = jax.random.split(key)
    rest, first = jax.random.split(sub)
    shape = (1, length, 1)
    x_t = torch.from_numpy(np.array(jax.random.normal(first, shape)))
    zs = [torch.from_numpy(np.array(jax.random.normal(k, shape)))
          for k in jax.random.split(rest, n_steps)]
    return x_t, zs


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("tts")
    binary = root / "binary"
    binary.mkdir()
    en = get_txt_processor_cls("en")
    phones = sorted({p for s in SENTENCES for p in en.process(s)[0]})
    (binary / "phone_set.json").write_text(json.dumps(phones))
    overrides = f"{SMALL},binary_data_dir={binary}"
    hp = set_hparams(config=CONFIG, hparams_str=overrides,
                     print_hparams=False, global_hparams=False)
    jhp = jax_hparams.set_hparams(config=CONFIG, hparams_str=overrides,
                                  print_hparams=False, global_hparams=False)
    encoder = build_token_encoder(str(binary / "phone_set.json"))
    tokens = [np.asarray(encoder.encode(" ".join(en.process(s)[0])))
              for s in SENTENCES]
    jtask = JaxTask(jhp)
    tree = _random_tree(jtask.model_cfg, seed=1)
    return dict(root=root, hp=hp, jhp=jhp, tokens=tokens, jtask=jtask,
                tree=tree, phones=phones)


def _random_fastdiff(hp: dict, seed: int = 0) -> dict:
    """Fused FastDiff weights shaped as JAX's (``jax.eval_shape``: nothing
    runs), drawn in numpy: N(0, 1/(4 fan_in)) weights, N(0, 0.05^2)
    biases."""
    cfg = JaxModelConfig.from_hparams(hp)
    shapes = jax.eval_shape(lambda k: fuse_weight_norm(init_fastdiff(k, cfg)),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(sds):
        z = rng.standard_normal(sds.shape)
        scale = 0.5 / np.sqrt(np.prod(sds.shape[:-1])) \
            if len(sds.shape) > 1 else 0.05
        return (z * scale).astype(np.float32)
    return jax.tree_util.tree_map(leaf, shapes)


class _JaxVocoder(JaxFastDiff):
    def _load_params(self, hp):
        return _random_fastdiff(hp)


@pytest.fixture(scope="module")
def jax_wav(setup):
    """JAX's ``infer_to_wav`` of the short sentence."""
    voc = _Recording(_JaxVocoder(setup["jhp"]))
    path = str(setup["root"] / "jax.wav")
    wav = setup["jtask"].infer_to_wav({"params": setup["tree"]},
                                      setup["tokens"][1], path, vocoder=voc)
    return wav, path, voc


def test_task_sizes_the_model_from_the_phone_set(setup):
    task = FastSpeech2Task(setup["hp"], device="cpu")
    assert task.model_cfg.vocab_size == len(setup["phones"]) + 3
    assert dataclasses.asdict(task.model_cfg) == \
        dataclasses.asdict(setup["jtask"].model_cfg)
    assert resolve_class(setup["hp"]["task_cls"]) is FastSpeech2Task


def test_front_end_token_ids_match_jax(setup):
    path = os.path.join(setup["hp"]["binary_data_dir"], "phone_set.json")
    ours = BaseTTSInfer(setup["hp"], build_token_encoder(path))
    ref = JaxBaseTTSInfer(setup["jhp"], jax_encoder(path))
    for s, tokens in zip(SENTENCES, setup["tokens"]):
        item = ours.preprocess_input(s)
        assert item == ref.preprocess_input(s)
        assert item["token_ids"] == list(tokens)


def test_infer_to_wav_matches_jax(setup, jax_wav):
    jwav, jpath, jax_voc = jax_wav
    hp = setup["hp"]
    task = FastSpeech2Task(hp, device="cpu")
    state = task.build_state(seed=0)
    state.model.load_state_dict(fs2_params_from_jax(setup["tree"],
                                                    task.model_cfg))
    ckpt = str(setup["root"] / "vocoder.pt")
    torch.save(params_from_jax(jax_voc.vocoder.params,
                               ModelConfig.from_hparams(hp)), ckpt)
    voc = FastDiffVocoder(dict(hp, vocoder_ckpt=ckpt), device="cpu")
    sampler, calls = voc.sampler, []

    def injected(state_dict, generator, mel, length):
        calls.append(length)
        return sampler(state_dict, generator, mel, length,
                       noise=_jax_draws(0, length))
    voc.sampler = injected
    rec = _Recording(voc)
    path = str(setup["root"] / "port.wav")
    wav = task.infer_to_wav(state, setup["tokens"][1], path, vocoder=rec)
    (mel,), (jmel,) = rec.mels, jax_voc.mels
    # random weights: durations of several frames, not the seed's one
    assert mel.shape == jmel.shape
    assert len(setup["tokens"][1]) < mel.shape[0] < 128
    np.testing.assert_allclose(mel, jmel, rtol=0, atol=1e-4)
    assert calls == [mel.shape[0] * voc.hop]
    assert wav.shape == jwav.shape == (mel.shape[0] * voc.hop,)
    assert np.isfinite(wav).all()
    np.testing.assert_allclose(wav, jwav, rtol=0, atol=1e-3)
    np.testing.assert_allclose(audio_io.load_wav(path)[0],
                               audio_io.load_wav(jpath)[0], rtol=0,
                               atol=1e-3)


def test_infer_to_wav_builds_its_vocoder_once(setup, tmp_path):
    task = FastSpeech2Task(setup["hp"], device="cpu")
    state = task.build_state(seed=0)
    assert state.step == 0
    vocoders = []
    tokens = setup["tokens"][1]
    for i in range(2):
        path = str(tmp_path / f"{i}.wav")
        wav = task.infer_to_wav(state, tokens, path)
        vocoders.append(task.vocoder)
        # at least one frame a phone, within max_frames
        hop = task.vocoder.hop
        assert wav.shape[0] % hop == 0
        assert len(tokens) <= wav.shape[0] // hop <= 128
        assert np.isfinite(wav).all()
        assert audio_io.load_wav(path)[0].shape == wav.shape
    assert isinstance(vocoders[0], FastDiffVocoder)
    assert vocoders[1] is vocoders[0]


def test_pipeline_and_demo_write_wavs(setup, tmp_path):
    hp = setup["hp"]
    mel_dir = tmp_path / "mels"
    mel_dir.mkdir()
    rng = np.random.default_rng(0)
    frames = {"a": 12, "b": 20}
    for name, n in frames.items():
        np.save(mel_dir / f"{name}.npy",
                rng.standard_normal((n, 80)).astype(np.float32) - 4)
    assert len(NpyMelSource(hp, str(mel_dir)).mel_paths) == 2
    out = tmp_path / "demo"
    assert demo_tts.main(["--config", CONFIG, "--mel_dir", str(mel_dir),
                          "--out_dir", str(out), "--hparams", SMALL,
                          "--device", "cpu"]) == 0
    assert sorted(os.listdir(out)) == ["a.wav", "b.wav"]
    for name, n in frames.items():
        wav, _ = audio_io.load_wav(str(out / f"{name}.wav"))
        # TTSPipeline writes peak-normalized 16-bit wavs
        assert wav.shape == (n * 256,)
        assert np.abs(wav).max() == pytest.approx(1, abs=1e-3)


def test_training_refuses(setup, tmp_path):
    """What the TTS path refused until the speaker encoder was ported
    (speaker embeddings in the binarizer, the encoder itself) now builds;
    the encoder asks for the card unless told otherwise, and the C++
    loader, refused until it was ported, resolves by JAX's name."""
    from fastdiff_tpu_torch.models.spk_encoder import (SpeakerEncoder,
                                                       get_speaker_encoder)
    hp = dict(setup["hp"], processed_data_dir=str(tmp_path),
              binary_data_dir=str(tmp_path / "binary"),
              binarization_args={"with_spk_embed": True})
    assert TTSBinarizer(hp).device == "cuda"
    assert TTSBinarizer(hp, device="cpu").device == "cpu"
    assert resolve_class(
        "fastdiff_tpu.models.spk_encoder.SpeakerEncoder") is SpeakerEncoder
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            get_speaker_encoder("", "cuda")
    from fastdiff_tpu_torch.data.native_io import NativeBatchLoader
    assert resolve_class(
        "fastdiff_tpu.data.native_io.NativeBatchLoader") is NativeBatchLoader
