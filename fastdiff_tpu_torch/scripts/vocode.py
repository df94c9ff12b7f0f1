"""Batch vocoding CLI (``scripts/vocode.py``): a directory of mels (or wavs)
-> waveforms through ``serving/batch_vocoder.py:BatchedVocoder`` on one
card.

    python -m fastdiff_tpu_torch.scripts.vocode \
        --config fastdiff_tpu/configs/ljspeech.yaml --input mels_dir \
        --out out_dir --hparams 'vocoder_ckpt=checkpoints/.../model_ckpt_steps_X.ckpt,N=4'

``.npy`` inputs are (T, n_mels) mels; ``.wav`` inputs are featurized with
the canonical front end first (``ops/dsp.py:wav2mel_np``; wav -> mel -> wav
resynthesis). Mels are padded to buckets of 128 frames and stacked
``--batch`` at a time (one CUDA graph per bucket and batch); the outputs are
peak-normalized 16-bit wavs, ``<name>.wav``. ``--device`` defaults to
``cuda`` and raises without a card.
"""

import argparse
import os
import sys
import time

import numpy as np

from fastdiff_tpu_torch.config import AudioConfig
from fastdiff_tpu_torch.ops.dsp import wav2mel_np
from fastdiff_tpu_torch.serving.batch_vocoder import BatchedVocoder
from fastdiff_tpu_torch.utils import audio_io
from fastdiff_tpu_torch.utils.hparams import set_hparams
from fastdiff_tpu_torch.vocoders.fastdiff_vocoder import FastDiffVocoder


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--input", required=True)
    parser.add_argument("--out", default="vocode_out")
    parser.add_argument("--hparams", default="")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    hp = set_hparams(config=args.config, hparams_str=args.hparams,
                     print_hparams=False)
    audio_cfg = AudioConfig.from_hparams(hp)
    voc = FastDiffVocoder(hp, device=args.device)

    names, mels = [], []
    for fn in sorted(os.listdir(args.input)):
        path = os.path.join(args.input, fn)
        if fn.endswith(".npy"):
            mels.append(np.asarray(np.load(path), np.float32))
        elif fn.endswith(".wav"):
            wav, _ = audio_io.load_wav(path, target_sr=audio_cfg.sample_rate)
            _, mel = wav2mel_np(wav, audio_cfg)
            mels.append(mel.T)
        else:
            continue
        names.append(os.path.splitext(fn)[0])
    if not mels:
        print(f"no .npy/.wav inputs in {args.input}")
        return 1

    bv = BatchedVocoder.from_sampler(voc.sample, voc.hop,
                                     max_batch=args.batch)
    t0 = time.perf_counter()
    wavs = bv.vocode(mels, generator=voc.generator)
    dt = time.perf_counter() - t0
    total_audio = sum(len(w) for w in wavs) / audio_cfg.sample_rate
    print(f"| vocoded {len(wavs)} utterances ({total_audio:.1f}s audio) in "
          f"{dt:.2f}s on {voc.device} (first calls of a shape run eagerly) "
          f"-> {total_audio / dt:.1f}x realtime aggregate")

    os.makedirs(args.out, exist_ok=True)
    for name, wav in zip(names, wavs):
        audio_io.save_wav(wav / max(1e-9, np.abs(wav).max()),
                          os.path.join(args.out, f"{name}.wav"),
                          audio_cfg.sample_rate)
    print(f"| wrote {len(wavs)} wavs -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
