"""Stage-1 preprocessing: raw dataset -> grouped wavs + metadata_phone.csv
(``fastdiff_tpu/data/pre_align.py``).

The reference's pre-align stage (data_gen/tts/vocoder_pre_align.py:20-99
and the per-dataset adapters of egs/datasets/audio/*/pre_align.py):
enumerate (item_name, wav_fn) pairs, optionally convert / resample / denoise
/ trim them, group the files under ``mfa_inputs/<group>/`` and write
``metadata_phone.csv`` for the binarizer. ``TTSPreAlign`` adds the text:
the ``txt_processor`` (``text/processors.py``) per utterance, a ``.lab``
beside each grouped wav for an MFA run, ``dict.txt``, ``mfa_dict.txt`` and
``phone_set.json``, and the ``txt, txt_raw, ph, spk`` columns. Adapters:
``LJPreAlign``, ``LJTTSPreAlign``, ``VCTKPreAlign``, ``LibriTTSPreAlign``.

``sox`` runs as a subprocess only when a ``pre_align_args`` flag asks for
it (the defaults process nothing); ``denoise`` is the port's spectral
subtraction (``vocoders/denoise.py``) on ``device``, the CUDA card unless
the caller names another, and silence trimming an energy trimmer in numpy.
"""

from __future__ import annotations

import csv
import glob
import json
import os
import shutil
import subprocess
from typing import Iterable, Tuple

import numpy as np

from fastdiff_tpu_torch.data.align import is_sil_phoneme
from fastdiff_tpu_torch.text.processors import get_txt_processor_cls
from fastdiff_tpu_torch.utils import audio_io
from fastdiff_tpu_torch.utils.multiprocess import chunked_multiprocess_run


def trim_silence(wav: np.ndarray, top_db: float = 60.0,
                 frame: int = 2048, hop: int = 512) -> np.ndarray:
    """Energy-based edge-silence trim (librosa.effects.trim semantics)."""
    if len(wav) < frame:
        return wav
    n_frames = 1 + (len(wav) - frame) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(frame)[None, :]
    rms = np.sqrt((wav[idx] ** 2).mean(axis=1) + 1e-12)
    db = 20.0 * np.log10(np.maximum(rms, 1e-10) / max(rms.max(), 1e-10))
    keep = np.where(db > -top_db)[0]
    if len(keep) == 0:
        return wav
    start = keep[0] * hop
    end = min(len(wav), keep[-1] * hop + frame)
    return wav[start:end]


class VocoderPreAlign:
    """Base pre-aligner; subclasses provide ``meta_data()``."""

    def __init__(self, hparams: dict, device="cuda"):
        self.hparams = hparams
        self.device = device
        self.pre_align_args = hparams.get("pre_align_args", {})
        self.raw_data_dir = hparams["raw_data_dir"]
        self.processed_dir = hparams["processed_data_dir"]

    def meta_data(self) -> Iterable[Tuple[str, str]]:
        """Yield (item_name, wav_fn[, txt, spk]) tuples; generic fallback
        globs *.wav up to two levels deep (egs/datasets/audio/pre_align.py)."""
        wav_fns = (sorted(glob.glob(f"{self.raw_data_dir}/*/*/*.wav"))
                   + sorted(glob.glob(f"{self.raw_data_dir}/*/*.wav"))
                   + sorted(glob.glob(f"{self.raw_data_dir}/*.wav")))
        for wav_fn in wav_fns:
            yield os.path.splitext(os.path.basename(wav_fn))[0], wav_fn

    @staticmethod
    def process_wav(idx: int, item_name: str, wav_fn: str, processed_dir: str,
                    pre_align_args: dict, sample_rate: int, device="cuda"):
        """Optional sox/denoise/trim chain (vocoder_pre_align.py:31-50); the
        denoiser's inverse STFT runs on ``device``."""
        needs_work = any(pre_align_args.get(k) for k in
                         ("sox_to_wav", "trim_sil", "sox_resample", "denoise"))
        if not needs_work:
            return wav_fn
        new_base = os.path.join(processed_dir, "wav_inputs", str(idx))
        subprocess.check_call(f'sox "{wav_fn}" -t wav "{new_base}.wav"', shell=True)
        if pre_align_args.get("sox_resample"):
            subprocess.check_call(
                f'sox -v 0.95 "{new_base}.wav" -r{sample_rate} "{new_base}_rs.wav"',
                shell=True)
            new_base += "_rs"
        if pre_align_args.get("denoise"):
            # native spectral subtraction replaces the reference's RNNoise
            # binary (vocoder_pre_align.py:39-41, utils/rnnoise.py)
            from fastdiff_tpu_torch.vocoders.denoise import \
                denoise as spectral_denoise
            wav, sr = audio_io.load_wav(new_base + ".wav", target_sr=sample_rate)
            wav = spectral_denoise(wav, c=0.15, device=device)
            audio_io.save_wav(wav, new_base + "_denoise.wav", sr)
            new_base += "_denoise"
        if pre_align_args.get("trim_sil"):
            wav, sr = audio_io.load_wav(new_base + ".wav", target_sr=sample_rate)
            wav = trim_silence(wav)
            audio_io.save_wav(wav, new_base + "_trim.wav", sr, norm=True)
            new_base += "_trim"
        return new_base + ".wav"

    @classmethod
    def process_job(cls, idx, item_name, wav_fn, processed_dir,
                    pre_align_args, sample_rate, device="cuda"):
        wav_fn = cls.process_wav(idx, item_name, wav_fn, processed_dir,
                                 pre_align_args, sample_rate, device)
        if wav_fn is None:
            return None
        group = idx // int(pre_align_args.get("nsample_per_group", 1000))
        group_dir = os.path.join(processed_dir, "mfa_inputs", str(group))
        os.makedirs(group_dir, exist_ok=True)
        ext = os.path.splitext(wav_fn)[1]
        new_wav_fn = os.path.join(group_dir, f"{idx:07d}_{item_name}{ext}")
        if "wav_inputs" in wav_fn:
            shutil.move(wav_fn, new_wav_fn)
        else:
            shutil.copy(wav_fn, new_wav_fn)
        return new_wav_fn

    def process(self) -> None:
        processed_dir = self.processed_dir
        shutil.rmtree(os.path.join(processed_dir, "mfa_inputs"), ignore_errors=True)
        os.makedirs(os.path.join(processed_dir, "wav_inputs"), exist_ok=True)
        sample_rate = int(self.hparams.get("audio_sample_rate", 22050))

        meta, args = [], []
        for idx, entry in enumerate(self.meta_data()):
            item_name, wav_fn = entry[0], entry[1]
            meta.append((item_name, wav_fn))
            args.append((idx, item_name, wav_fn, processed_dir,
                         self.pre_align_args, sample_rate, self.device))
        names = [m[0] for m in meta]
        assert len(names) == len(set(names)), "item_name must be unique"

        rows = []
        for (item_name, wav_fn), res in zip(
                meta, chunked_multiprocess_run(self.process_job, args)):
            if res is None:
                print(f"| Skip {wav_fn}.")
                continue
            rows.append({"item_name": item_name, "wav_fn": res})

        os.makedirs(processed_dir, exist_ok=True)
        with open(os.path.join(processed_dir, "metadata_phone.csv"), "w",
                  newline="") as f:
            writer = csv.DictWriter(f, fieldnames=["item_name", "wav_fn"])
            writer.writeheader()
            writer.writerows(rows)
        print(f"| pre-align wrote {len(rows)} items -> {processed_dir}/metadata_phone.csv")


class TTSPreAlign(VocoderPreAlign):
    """TTS-side pre-align: G2P + MFA dictionary / phone-set generation.

    Covers the reference ``BasePreAlign`` behaviors the vocoder stage skips
    (reference: data_gen/tts/base_pre_align.py:58-141):

    - runs the configured ``txt_processor`` over each utterance's text,
    - phone post-processing: strip edge silences, add <BOS>/<EOS>, collapse
      silence runs,
    - emits per-utterance ``.lab`` files (word-level alignment text) next to
      the grouped ``mfa_inputs`` wavs for a Montreal-Forced-Aligner run,
    - writes ``dict.txt`` (phone->phone), ``phone_set.json`` and
      ``mfa_dict.txt`` (word -> phone pronunciations) to the processed dir,
    - metadata_phone.csv gains ``txt, txt_raw, ph, spk`` columns, which the
      TTS binarizer consumes (data/tts_binarizer.py).

    ``meta_data()`` yields (item_name, wav_fn, txt, spk); the generic
    fallback reads sidecar ``<wav>.txt`` / ``<wav>.lab`` transcripts.
    """

    def __init__(self, hparams: dict, device="cuda"):
        super().__init__(hparams, device)
        self.txt_processor = get_txt_processor_cls(
            self.pre_align_args.get("txt_processor", "en"))

    def meta_data(self):
        for item_name, wav_fn in super().meta_data():
            txt = None
            base = os.path.splitext(wav_fn)[0]
            for ext in (".normalized.txt", ".txt", ".lab"):
                if os.path.exists(base + ext):
                    with open(base + ext) as f:
                        txt = f.read().strip()
                    break
            yield item_name, wav_fn, txt, "SPK0"

    @staticmethod
    def sp_phonemes():
        return ["|"]

    @classmethod
    def process_text(cls, txt_processor, txt_raw: str, pre_align_args: dict):
        """G2P + phone post-processing; returns (ph, word_prons, ph_for_align,
        txt) — the reference's process_text contract."""
        phs, txt = txt_processor.process(txt_raw, pre_align_args)
        phs = [p.strip() for p in phs if p.strip()]
        # boundary markers that are word separators (NOT audible silence):
        # the processor's own list when it defines one (zh adds '#'),
        # else this class's default (reference: base_pre_align.py:135
        # consults txt_processor.sp_phonemes())
        sp_phonemes = getattr(txt_processor, "sp_phonemes", cls.sp_phonemes)()
        while phs and is_sil_phoneme(phs[0]):
            phs = phs[1:]
        while phs and is_sil_phoneme(phs[-1]):
            phs = phs[:-1]
        phs = ["<BOS>"] + phs + ["<EOS>"]
        collapsed = []
        for p in phs:    # collapse silence runs, keeping the stronger token
            if not collapsed or not is_sil_phoneme(p) \
                    or not is_sil_phoneme(collapsed[-1]):
                collapsed.append(p)
            elif collapsed[-1] == "|" and p != "|":
                collapsed[-1] = p
        # word-level views for the MFA dictionary and .lab alignment text
        cur_word, ph_for_align, word_prons = [], [], set()
        for p in collapsed:
            if is_sil_phoneme(p):
                if cur_word:
                    ph_for_align.append("_".join(cur_word))
                    word_prons.add(" ".join(cur_word))
                    cur_word = []
                if p not in sp_phonemes:
                    ph_for_align.append("SIL")
            else:
                cur_word.append(p)
        if cur_word:
            ph_for_align.append("_".join(cur_word))
            word_prons.add(" ".join(cur_word))
        return (" ".join(collapsed), word_prons, " ".join(ph_for_align), txt)

    def process(self) -> None:
        processed_dir = self.processed_dir
        shutil.rmtree(os.path.join(processed_dir, "mfa_inputs"),
                      ignore_errors=True)
        os.makedirs(os.path.join(processed_dir, "wav_inputs"), exist_ok=True)
        sample_rate = int(self.hparams.get("audio_sample_rate", 22050))
        allow_no_txt = bool(self.pre_align_args.get("allow_no_txt", True))

        phone_set, word_dict, rows = set(), set(), []
        for idx, (item_name, wav_fn, txt_raw, spk) in enumerate(self.meta_data()):
            if txt_raw is None:
                if not allow_no_txt:
                    raise FileNotFoundError(f"no transcript for {wav_fn}")
                txt_raw = "NO_TEXT"
            ph, word_prons, ph_align, txt = self.process_text(
                self.txt_processor, txt_raw, self.pre_align_args)
            new_wav = self.process_job(idx, item_name, wav_fn, processed_dir,
                                       self.pre_align_args, sample_rate,
                                       self.device)
            if new_wav is None:
                print(f"| Skip {wav_fn}.")
                continue
            # alignment text beside the grouped wav, for the MFA run
            with open(os.path.splitext(new_wav)[0] + ".lab", "w") as f:
                f.write(ph_align)
            rows.append({"item_name": item_name, "wav_fn": new_wav,
                         "txt": txt, "txt_raw": txt_raw, "ph": ph,
                         "spk": spk})
            phone_set.update(ph.split())
            word_prons.add("SIL")
            for pron in word_prons:
                word_dict.add(f"{pron.replace(' ', '_')} {pron}")

        os.makedirs(processed_dir, exist_ok=True)
        with open(os.path.join(processed_dir, "metadata_phone.csv"), "w",
                  newline="") as f:
            writer = csv.DictWriter(f, fieldnames=[
                "item_name", "wav_fn", "txt", "txt_raw", "ph", "spk"])
            writer.writeheader()
            writer.writerows(rows)
        with open(os.path.join(processed_dir, "dict.txt"), "w") as f:
            for ph in sorted(phone_set):
                f.write(f"{ph} {ph}\n")
        with open(os.path.join(processed_dir, "phone_set.json"), "w") as f:
            json.dump(sorted(phone_set), f)
        with open(os.path.join(processed_dir, "mfa_dict.txt"), "w") as f:
            for line in sorted(word_dict):
                f.write(line + "\n")
        print(f"| tts pre-align: {len(rows)} items, {len(phone_set)} phones "
              f"-> {processed_dir}")


class LJPreAlign(VocoderPreAlign):
    """LJSpeech: parse metadata.csv (egs/datasets/audio/lj/pre_align.py)."""

    def meta_data(self):
        with open(os.path.join(self.raw_data_dir, "metadata.csv")) as f:
            for line in f:
                item_name = line.strip().split("|")[0]
                yield item_name, os.path.join(self.raw_data_dir, "wavs",
                                              f"{item_name}.wav")


class LJTTSPreAlign(TTSPreAlign):
    """LJSpeech with transcripts: metadata.csv '|' columns (id, raw text,
    normalized text) -> G2P pre-align."""

    def meta_data(self):
        with open(os.path.join(self.raw_data_dir, "metadata.csv")) as f:
            for line in f:
                parts = line.strip().split("|")
                wav_fn = os.path.join(self.raw_data_dir, "wavs",
                                      f"{parts[0]}.wav")
                yield parts[0], wav_fn, parts[-1], "SPK0"


class VCTKPreAlign(VocoderPreAlign):
    """VCTK: wav48/<spk>/*.wav (egs/datasets/audio/vctk/pre_align.py)."""

    def meta_data(self):
        for wav_fn in glob.glob(f"{self.raw_data_dir}/wav48/*/*.wav"):
            yield os.path.basename(wav_fn)[:-4], wav_fn


class LibriTTSPreAlign(VocoderPreAlign):
    """LibriTTS: <spk>/<chapter>/*.wav (egs/datasets/audio/libritts/pre_align.py)."""

    def meta_data(self):
        for wav_fn in sorted(glob.glob(f"{self.raw_data_dir}/*/*/*.wav")):
            yield os.path.basename(wav_fn)[:-4], wav_fn
