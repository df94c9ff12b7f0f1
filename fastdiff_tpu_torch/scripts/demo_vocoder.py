"""Minimal library-level demo: checkpoint -> schedule -> sample -> wav
(``scripts/demo_vocoder.py``; the script form of the reference's
egs/demo.ipynb cells):

    python -m fastdiff_tpu_torch.scripts.demo_vocoder \
        --ckpt model_ckpt_steps_500000.ckpt \
        --wav egs/audios/LJ001-0001_gt.wav --N 4 --out demo_out

The checkpoint is a released one of the reference, a bare state_dict or a
port ``Trainer`` checkpoint (``vocoders/fastdiff_vocoder.py:
inference_state_dict``); without ``--ckpt`` the model runs seed-0
weights (noise out, timing only). The input wav is featurized with
``ops/dsp.py:wav2mel_np`` and resynthesized by the graph sampler over the
inference ``FastDiff`` (``ModelConfig()``, the ``auto`` route) with the
derived N-step schedule. The first call runs eagerly and the second
captures the CUDA graph; the third, a replay, is timed (CUDA events on the
card) for the real-time factor. Writes ``<name>_pred.wav`` (peak
normalized) and ``<name>_gt.wav``, and prints the MCD against the input
when a checkpoint is given. ``--device`` defaults to ``cuda`` and raises
without a card.
"""

import argparse
import os
import time

import numpy as np
import torch

from fastdiff_tpu_torch.config import AudioConfig, ModelConfig
from fastdiff_tpu_torch.diffusion.sampler import (constants_for_hparams,
                                                  inference_generator,
                                                  make_sampler)
from fastdiff_tpu_torch.models.fastdiff import FastDiff, checked_device
from fastdiff_tpu_torch.ops.dsp import wav2mel_np
from fastdiff_tpu_torch.training.checkpoint import load_checkpoint
from fastdiff_tpu_torch.utils import audio_io, metrics
from fastdiff_tpu_torch.vocoders.fastdiff_vocoder import inference_state_dict


def timed_seconds(fn, device: torch.device) -> tuple:
    """(fn's result, its seconds): CUDA events on the card, the host clock
    on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize(device)
    return out, start.elapsed_time(end) / 1e3


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", default="",
                        help="released, state_dict or Trainer checkpoint")
    parser.add_argument("--wav", required=True,
                        help="input wav (analysis + resynthesis)")
    parser.add_argument("--N", type=int, default=4)
    parser.add_argument("--out", default="demo_out")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    device = checked_device(args.device)
    audio_cfg = AudioConfig()
    model_cfg = ModelConfig()

    # 1. checkpoint (released / state_dict / Trainer), else seed weights
    model = FastDiff(model_cfg, seed=None if args.ckpt else 0)
    if args.ckpt:
        model.load_state_dict(inference_state_dict(
            load_checkpoint(args.ckpt, map_location="cpu"), model_cfg))
    else:
        print("| no --ckpt: using random weights (noise out, timing only)")
    model = model.to(device).eval()

    # 2. derived noise schedule for N reverse steps (training schedule of
    # DiffusionConfig())
    constants = constants_for_hparams({"N": args.N})
    print(f"| N={args.N} fractional steps: {constants.steps}")

    # 3. analyze the input wav -> mel
    wav, _ = audio_io.load_wav(args.wav, target_sr=audio_cfg.sample_rate)
    wav, mel = wav2mel_np(wav, audio_cfg)
    mel_dev = torch.from_numpy(np.ascontiguousarray(mel.T))[None].to(device)
    length = mel.shape[1] * audio_cfg.hop_size

    # 4. sample: eager first call, capture, then the timed replay
    sampler = make_sampler(model, constants)
    for seed in (42, 43):
        sampler(inference_generator(seed, device), mel_dev, length)
    gen = inference_generator(44, device)
    out, dt = timed_seconds(lambda: sampler(gen, mel_dev, length), device)
    pred = out[0, :, 0].cpu().numpy()
    rtf = metrics.compute_rtf(dt, len(pred), audio_cfg.sample_rate)
    print(f"| generated {len(pred) / audio_cfg.sample_rate:.2f}s in "
          f"{dt * 1000:.1f}ms -> RTF {rtf:.4f} ({1 / rtf:.0f}x realtime) "
          f"on {device}")

    os.makedirs(args.out, exist_ok=True)
    name = os.path.splitext(os.path.basename(args.wav))[0]
    audio_io.save_wav(pred / max(1e-9, np.abs(pred).max()),
                      os.path.join(args.out, f"{name}_pred.wav"),
                      audio_cfg.sample_rate)
    audio_io.save_wav(wav, os.path.join(args.out, f"{name}_gt.wav"),
                      audio_cfg.sample_rate)
    if args.ckpt:
        print(f"| MCD vs input: {metrics.mcd(pred, wav, audio_cfg):.2f} dB")
    print(f"| wrote {args.out}/{name}_pred.wav")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
