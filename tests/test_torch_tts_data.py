"""The port's TTS data pipeline and its training loop against the JAX
package's on the CPU.

- ``parse_textgrid`` / ``align_textgrid`` equal to JAX's on a hand-written
  TextGrid and on MFA-style TextGrids of every utterance below
  (``data/align.py:mfa_textgrid``, which JAX's parser reads back);
- ``TTSPreAlign`` (``en`` and ``zh`` processors) and ``VocoderPreAlign``:
  every file they write equal to JAX's byte for byte, the output directory
  aside;
- ``TTSBinarizer`` (alignment, f0, cwt) and ``ZhBinarizer`` records equal
  to JAX's key for key, and the same ``phone_set.json``, ``spk_map.json``,
  ``word_set.json`` and lengths;
- ``collate_tts`` on those records equal to JAX's array for array, frame
  and cwt;
- ``Trainer.fit`` of ``FastSpeech2Task`` for 4 steps: checkpoints
  written, a restore equal to the saved state, the validation figures as
  PNGs.

The data is ``tests/test_tts_binarizer.py:_make_tts_dataset`` (five 0.5 s
tones) with a TextGrid per utterance, binarized once per package for the
module.
"""

import csv
import glob
import json
import os

import numpy as np
import pytest
import torch

from fastdiff_tpu.data import align as jalign
from fastdiff_tpu.data import pre_align as jpre
from fastdiff_tpu.data.indexed_dataset import IndexedDataset as JaxIndexed
from fastdiff_tpu.data.tts_binarizer import TTSBinarizer as JaxTTSBinarizer
from fastdiff_tpu.data.zh_binarizer import ZhBinarizer as JaxZhBinarizer
from fastdiff_tpu.training.tts_task import collate_tts as jax_collate
from fastdiff_tpu_torch.data import align, pre_align
from fastdiff_tpu_torch.data.dataset import VocoderDataset, resolve_class
from fastdiff_tpu_torch.data.indexed_dataset import IndexedDataset
from fastdiff_tpu_torch.data.tts_binarizer import TTSBinarizer
from fastdiff_tpu_torch.data.zh_binarizer import ZhBinarizer
from fastdiff_tpu_torch.training import checkpoint as ckpt
from fastdiff_tpu_torch.training.trainer import Trainer
from fastdiff_tpu_torch.training.tts_task import FastSpeech2Task, collate_tts
from fastdiff_tpu_torch.utils import audio_io
from tests.test_align import TG
from tests.test_tts_binarizer import _make_tts_dataset
from tests.test_tts_pre_align import _make_zh_raw
from tests.test_zh_binarizer import _make_zh_dataset


SMALL = {"hidden_size": 32, "enc_layers": 1, "dec_layers": 1,
         "num_heads": 2, "ffn_hidden": 64, "enc_ffn_kernel_size": 3,
         "max_frames": 200, "use_pitch_embed": True}


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


def _records(path: str, reader) -> list:
    ds = reader(path)
    return [ds[i] for i in range(len(ds))]


def _assert_records_equal(ours: list, ref: list):
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert sorted(a) == sorted(b), (sorted(a), sorted(b))
        for key in b:
            if isinstance(b[key], np.ndarray):
                assert a[key].dtype == b[key].dtype, key
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
            else:
                assert a[key] == b[key], key


def _add_textgrids(hp: dict) -> None:
    """An MFA-style TextGrid per utterance, named in a ``tg_fn`` column."""
    fn = os.path.join(hp["processed_data_dir"], "metadata_phone.csv")
    with open(fn, newline="") as f:
        rows = list(csv.DictReader(f))
    rng = np.random.default_rng(7)
    for r in rows:
        wav, sr = audio_io.load_wav(r["wav_fn"])
        r["tg_fn"] = os.path.splitext(r["wav_fn"])[0] + ".TextGrid"
        with open(r["tg_fn"], "w") as f:
            f.write(align.mfa_textgrid(r["ph"].split(), len(wav) / sr, rng))
    with open(fn, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)


def _binarize(hp: dict, ours, ref) -> tuple:
    """Binarize ``hp``'s corpus with each package into its own directory;
    (port hparams, JAX hparams)."""
    out = []
    for cls, name in ((ours, "binary"), (ref, "binary_jax")):
        h = dict(hp, binary_data_dir=os.path.join(hp["processed_data_dir"],
                                                  name))
        cls(h).process()
        out.append(h)
    return tuple(out)


@pytest.fixture(scope="module")
def tts_data(tmp_path_factory):
    hp = _make_tts_dataset(tmp_path_factory.mktemp("tts_data"), n_items=5)
    hp["binarization_args"] = dict(hp["binarization_args"], with_align=True,
                                   with_f0cwt=True)
    _add_textgrids(hp)
    return _binarize(hp, TTSBinarizer, JaxTTSBinarizer)


# -- align -------------------------------------------------------------------

def test_textgrid_alignment_equal():
    phones = ["<BOS>", "HH", "AY", "<EOS>"]
    text = align.mfa_textgrid(phones, 1.0, np.random.default_rng(0))
    for tg in (TG, text):
        assert align.parse_textgrid(tg) == jalign.parse_textgrid(tg)
    tiers = jalign.parse_textgrid(text)
    assert [t for _, _, t in tiers[1]] == ["sil", "HH", "AY", ""]
    assert tiers[1][0][0] == 0.0 and tiers[1][-1][1] == 1.0
    for tg in (TG, text):
        for n_frames, sr, hop in ((86, 22050, 256), (40, 16000, 400)):
            for a, b in zip(align.align_textgrid(tg, phones, n_frames, sr, hop),
                            jalign.align_textgrid(tg, phones, n_frames, sr,
                                                  hop)):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype
    for bad in (["<BOS>", "HH", "<EOS>"], ["HH", "|", "AY", "EY"]):
        with pytest.raises(ValueError):
            align.align_textgrid(TG, bad, 86, 22050, 256)


def test_mfa_textgrids_align_as_jax(tts_data):
    hp, _ = tts_data
    with open(os.path.join(hp["processed_data_dir"],
                           "metadata_phone.csv")) as f:
        rows = list(csv.DictReader(f))
    counts = []
    for r in rows:
        with open(r["tg_fn"]) as f:
            tg = f.read()
        phones = r["ph"].split()
        ours = align.align_textgrid(tg, phones, 44, 22050, 256)
        ref = jalign.align_textgrid(tg, phones, 44, 22050, 256)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
        counts.append(int((ours[1] > 0).sum()))
        # a word boundary gets no frame; every spoken phone gets some
        assert all(d == 0 for d, p in zip(ours[1], phones) if p == "|")
    assert sum(counts) > len(rows)


# -- pre-align ---------------------------------------------------------------

def _tree_bytes(root: str) -> dict:
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read().replace(
                    root.encode(), b"<ROOT>")
    return out


@pytest.mark.parametrize("kind", ["tts_zh", "tts_en", "vocoder"])
def test_pre_align_files_equal(kind, tmp_path, monkeypatch):
    monkeypatch.setenv("N_PROC", "1")
    hp = _make_zh_raw(tmp_path)
    if kind == "tts_en":
        hp["pre_align_args"] = dict(hp["pre_align_args"], txt_processor="en")
        for i, fn in enumerate(sorted(glob.glob(f"{hp['raw_data_dir']}/*.txt"))):
            with open(fn, "w") as f:
                f.write(["Good morning, everyone.", "It is 42 degrees!",
                         "Printing, in the only sense."][i % 3])
    ours_cls, ref_cls = {
        "vocoder": (pre_align.VocoderPreAlign, jpre.VocoderPreAlign),
    }.get(kind, (pre_align.TTSPreAlign, jpre.TTSPreAlign))
    trees = []
    for cls, name in ((ours_cls, "port"), (ref_cls, "jax")):
        out = str(tmp_path / name)
        if cls is ours_cls:
            cls(dict(hp, processed_data_dir=out), device="cpu").process()
        else:
            cls(dict(hp, processed_data_dir=out)).process()
        trees.append(_tree_bytes(out))
    ours, ref = trees
    assert sorted(ours) == sorted(ref)
    assert ours == ref
    n_wavs = sum(name.endswith(".wav") for name in ours)
    assert n_wavs == 5
    if kind != "vocoder":
        assert sum(name.endswith(".lab") for name in ours) == 5
        assert {"dict.txt", "mfa_dict.txt", "phone_set.json"} <= set(ours)


def test_pre_align_cli_class_paths():
    for name in ("VocoderPreAlign", "TTSPreAlign", "LJPreAlign",
                 "LJTTSPreAlign", "VCTKPreAlign", "LibriTTSPreAlign"):
        cls = resolve_class(f"fastdiff_tpu.data.pre_align.{name}")
        assert cls is getattr(pre_align, name)
    assert resolve_class("fastdiff_tpu.data.tts_binarizer.TTSBinarizer") \
        is TTSBinarizer
    assert resolve_class("fastdiff_tpu.data.zh_binarizer.ZhBinarizer") \
        is ZhBinarizer


def test_trim_silence_equal():
    rng = np.random.default_rng(3)
    wav = np.concatenate([1e-4 * rng.standard_normal(6000),
                          0.5 * rng.standard_normal(9000),
                          1e-4 * rng.standard_normal(7000)]).astype(np.float32)
    for w in (wav, wav[:1000]):
        np.testing.assert_array_equal(pre_align.trim_silence(w),
                                      jpre.trim_silence(w))
    assert len(pre_align.trim_silence(wav)) < len(wav)


# -- binarizers --------------------------------------------------------------

def test_tts_binarizer_records_equal(tts_data):
    hp, jhp = tts_data
    ours_dir, ref_dir = hp["binary_data_dir"], jhp["binary_data_dir"]
    for fn in ("phone_set.json", "spk_map.json"):
        with open(os.path.join(ours_dir, fn)) as a, \
                open(os.path.join(ref_dir, fn)) as b:
            assert json.load(a) == json.load(b)
    for prefix in ("valid", "test", "train"):
        np.testing.assert_array_equal(
            np.load(os.path.join(ours_dir, f"{prefix}_lengths.npy")),
            np.load(os.path.join(ref_dir, f"{prefix}_lengths.npy")))
        ours = _records(os.path.join(ours_dir, prefix), IndexedDataset)
        _assert_records_equal(
            ours, _records(os.path.join(ref_dir, prefix), JaxIndexed))
        for item in ours:
            assert {"mel2ph", "dur", "f0", "pitch", "cwt_spec"} <= set(item)
            assert item["dur"].sum() == item["len"]


def test_zh_binarizer_records_equal(tmp_path):
    hp = _make_zh_dataset(tmp_path)
    hp, jhp = _binarize(hp, ZhBinarizer, JaxZhBinarizer)
    with open(os.path.join(hp["binary_data_dir"], "word_set.json")) as a, \
            open(os.path.join(jhp["binary_data_dir"], "word_set.json")) as b:
        assert json.load(a) == json.load(b)
    for prefix in ("valid", "train"):
        ours = _records(os.path.join(hp["binary_data_dir"], prefix),
                        IndexedDataset)
        _assert_records_equal(ours, _records(
            os.path.join(jhp["binary_data_dir"], prefix), JaxIndexed))
        assert all({"ph_words", "mel2word", "f0_ph", "word_tokens"}
                   <= set(item) for item in ours)


@pytest.mark.parametrize("pitch_type", ["frame", "cwt"])
def test_collate_tts_equal(tts_data, pitch_type):
    hp, _ = tts_data
    items = _records(os.path.join(hp["binary_data_dir"], "train"),
                     IndexedDataset)
    # one item without alignment: the uniform fallback
    items.append({k: v for k, v in items[0].items() if k != "mel2ph"})
    ours = collate_tts(items, 24, 64, 80, pitch_type=pitch_type)
    ref = jax_collate(items, 24, 64, 80, pitch_type=pitch_type)
    assert sorted(ours) == sorted(ref)
    for key in ref:
        assert ours[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


# -- the training loop -------------------------------------------------------

def test_fit_restore_and_figures(tts_data, tmp_path):
    hp, _ = tts_data
    work = str(tmp_path / "work")
    hp = dict(hp, **SMALL, max_samples=256, max_sentences=2,
              max_valid_sentences=1, max_updates=4, val_check_interval=2,
              num_sanity_val_steps=1, tb_log_interval=2, eval_max_batches=1,
              num_ckpt_keep=2, num_valid_plots=2, lr=1e-3,
              scheduler="none", seed=0, work_dir=work)
    task = FastSpeech2Task(hp, device="cpu")
    batch = next(task.train_dataloader())
    assert batch["tokens"].shape[1] % 8 == 0
    assert batch["mels"].shape[1] % 32 == 0
    assert len(VocoderDataset(hp, "train")) == 4
    result = Trainer(task, work).fit()
    assert result["step"] == 4 and result["state"].step == 4
    paths = sorted(glob.glob(os.path.join(work, "model_ckpt_steps_*.ckpt")))
    assert [os.path.basename(p) for p in paths] == [
        "model_ckpt_steps_2.ckpt", "model_ckpt_steps_4.ckpt"]
    assert np.isfinite(result["val"]["loss"])
    pngs = glob.glob(os.path.join(work, "tb_logs", "figures", "*.png"))
    assert sorted(os.path.basename(p) for p in pngs) == [
        "mel_val_0_2.png", "mel_val_0_4.png"]

    saved = ckpt.load_checkpoint(paths[-1])
    fresh = FastSpeech2Task(hp, device="cpu")
    state, step = Trainer(fresh, work).restore(fresh.build_state(seed=5))
    assert step == 4 and state.step == 4
    trained = result["state"].model.state_dict()
    for name, value in state.model.state_dict().items():
        assert torch.equal(value, saved["params"][name]), name
        assert torch.equal(value, trained[name]), name
    for a, b in zip(state.optimizer.mu + state.optimizer.nu,
                    result["state"].optimizer.mu + result["state"].optimizer.nu):
        assert torch.equal(a, b)
    assert state.optimizer.count == 4
    # the restored state trains on as the original does
    batch = next(fresh.train_dataloader())
    assert fresh.train_step(state, batch) == task.train_step(result["state"],
                                                             batch)
