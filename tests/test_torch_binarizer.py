"""The port's binarizer and inference featurizing against the JAX package's
(``fastdiff_tpu_torch/data/{binarizer,binarize,dataset}.py``).

Both packages binarize the same synthesized wavs from a metadata CSV that
the test writes: the pickle records (item_name, wav_fn, mel, wav f16, len,
sec) and ``<prefix>_lengths.npy`` are equal, for the PWG-style and the
Tacotron binarizer, inline and over spawned workers. ``process_mel_item``
and the dataset's ``test_input_dir`` / ``test_mel_dir`` items equal JAX's.
"""

import os
import sys

import numpy as np
import pytest
import torch

from fastdiff_tpu.data import binarizer as jbin
from fastdiff_tpu.data import dataset as jds
from fastdiff_tpu.data.indexed_dataset import IndexedDataset as JaxIndexed
from fastdiff_tpu.utils import audio_io as jaudio
from fastdiff_tpu_torch.data import binarize as port_binarize
from fastdiff_tpu_torch.data import binarizer as pbin
from fastdiff_tpu_torch.data import dataset as pds
from fastdiff_tpu_torch.data.indexed_dataset import IndexedDataset

SR = 22050
SECONDS = (0.7, 1.1, 0.55, 0.9)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch intra-op thread: the suite runs several workers on the
    machine's cores, and torch's CPU kernels oversubscribe them (a 60-step
    training test took 135 s under five busy neighbours, 0.8 s with one
    thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Four wavs (one at 16 kHz, resampled on load) and a metadata CSV."""
    root = tmp_path_factory.mktemp("corpus")
    raw = root / "raw"
    raw.mkdir()
    processed = root / "processed"
    processed.mkdir()
    rng = np.random.default_rng(0)
    rows = []
    for i, sec in enumerate(SECONDS):
        sr = 16000 if i == 2 else SR
        t = np.arange(int(sec * sr)) / sr
        wav = (0.4 * np.sin(2 * np.pi * (180 + 60 * i) * t)
               + 0.03 * rng.standard_normal(len(t))).astype(np.float32)
        fn = str(raw / f"utt{i}.wav")
        jaudio.save_wav(wav, fn, sr)
        rows.append(f"utt{i},{fn}")
    with open(processed / "metadata_phone.csv", "w") as f:
        f.write("item_name,wav_fn\n" + "\n".join(rows) + "\n")
    return root


def _hparams(root, name, **kw):
    hp = {"processed_data_dir": str(root / "processed"),
          "binary_data_dir": str(root / name),
          "audio_sample_rate": SR, "audio_num_mel_bins": 80,
          "fft_size": 1024, "hop_size": 256, "win_size": 1024,
          "fmin": 80, "fmax": 7600, "test_num": 1, "max_samples": 4096,
          "binarization_args": {"with_wav": True, "shuffle": False},
          "N_PROC": 1}
    hp.update(kw)
    return hp


def _records(path):
    ds = JaxIndexed(path)
    return [ds[i] for i in range(len(ds))]


def _assert_same_split(port_dir, jax_dir, prefix):
    np.testing.assert_array_equal(
        np.load(os.path.join(port_dir, f"{prefix}_lengths.npy")),
        np.load(os.path.join(jax_dir, f"{prefix}_lengths.npy")))
    got = _records(os.path.join(port_dir, prefix))
    want = _records(os.path.join(jax_dir, prefix))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        for key in a:
            if isinstance(a[key], np.ndarray):
                assert a[key].dtype == b[key].dtype, key
                np.testing.assert_array_equal(a[key], b[key])
            else:
                assert a[key] == b[key], key


@pytest.mark.parametrize("kind,n_proc", [
    ("VocoderBinarizer", 1), ("TacotronVocoderBinarizer", 1),
    ("VocoderBinarizer", 2)])
def test_binarized_records_equal_jax(corpus, kind, n_proc):
    hp_port = _hparams(corpus, f"port_{kind}_{n_proc}", N_PROC=n_proc)
    hp_jax = _hparams(corpus, f"jax_{kind}", N_PROC=1)
    getattr(pbin, kind)(hp_port).process()
    getattr(jbin, kind)(hp_jax).process()
    for prefix in ("train", "valid", "test"):
        _assert_same_split(hp_port["binary_data_dir"],
                           hp_jax["binary_data_dir"], prefix)
    # the port reads its own shards; valid == test, the rest train
    train = IndexedDataset(os.path.join(hp_port["binary_data_dir"], "train"))
    assert len(train) == len(SECONDS) - 1
    item = train[0]
    assert item["mel"].dtype == np.float32 and item["wav"].dtype == np.float16
    assert len(item["wav"]) == item["mel"].shape[0] * 256


def test_binarize_cli(corpus, tmp_path, monkeypatch):
    """``python -m fastdiff_tpu_torch.data.binarize --config ...``: the
    config's ``binarizer_cls`` (a JAX path) resolves to the port's class."""
    cfg = tmp_path / "conf.yaml"
    cfg.write_text(
        "binarizer_cls: fastdiff_tpu.data.binarizer.VocoderBinarizer\n"
        f"processed_data_dir: '{corpus / 'processed'}'\n"
        f"binary_data_dir: '{tmp_path / 'bin'}'\n"
        "test_num: 1\nN_PROC: 1\nbinarization_args:\n  with_wav: true\n")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["binarize", "--config", str(cfg)])
    port_binarize.main()
    hp_jax = _hparams(corpus, "jax_cli")
    jbin.VocoderBinarizer(hp_jax).process()
    for prefix in ("train", "valid"):
        _assert_same_split(str(tmp_path / "bin"), hp_jax["binary_data_dir"],
                           prefix)


def test_process_mel_item_equals_jax():
    mel = np.random.default_rng(1).standard_normal((37, 80))
    got = pbin.VocoderBinarizer.process_mel_item("m", mel, None, {})
    want = jbin.VocoderBinarizer.process_mel_item("m", mel, None, {})
    assert sorted(got) == sorted(want)
    for key in got:
        if isinstance(got[key], np.ndarray):
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
        else:
            assert got[key] == want[key]


def _infer_items(module, hp):
    return list(module.infer_item_iterator(module.VocoderDataset(hp, "test")))


@pytest.mark.parametrize("source", ["test_input_dir", "test_mel_dir"])
def test_infer_items_equal_jax(corpus, tmp_path, source):
    hp = _hparams(corpus, "unused", use_wav=True,
                  binarizer_cls="fastdiff_tpu.data.binarizer.VocoderBinarizer")
    if source == "test_input_dir":
        hp[source] = str(corpus / "raw")
    else:
        rng = np.random.default_rng(2)
        for i, frames in enumerate((40, 131)):
            np.save(str(tmp_path / f"m{i}.npy"),
                    rng.standard_normal((frames, 80)).astype(np.float32))
        hp[source] = str(tmp_path)
    got, want = _infer_items(pds, hp), _infer_items(jds, hp)
    assert [g["item_name"] for g in got] == [w["item_name"] for w in want]
    assert len(got) == (len(SECONDS) if source == "test_input_dir" else 2)
    for a, b in zip(got, want):
        assert sorted(a) == sorted(b)
        assert ("wavs" in a) == (source == "test_input_dir")
        for key in ("mels", "wavs"):
            if key in a:
                np.testing.assert_array_equal(a[key], b[key])


def test_resolve_class_maps_the_jax_names():
    assert pds.resolve_class(
        "fastdiff_tpu.data.binarizer.TacotronVocoderBinarizer") is \
        pbin.TacotronVocoderBinarizer
    from fastdiff_tpu_torch.data.tts_binarizer import TTSBinarizer
    assert pds.resolve_class(
        "fastdiff_tpu.data.tts_binarizer.TTSBinarizer") is TTSBinarizer
    from fastdiff_tpu_torch.models.spk_encoder import SpeakerEncoder
    assert pds.resolve_class(
        "fastdiff_tpu.models.spk_encoder.SpeakerEncoder") is SpeakerEncoder
    from fastdiff_tpu_torch.parallel.mesh import make_mesh
    assert pds.resolve_class("fastdiff_tpu.parallel.mesh.make_mesh") is \
        make_mesh
