"""End-to-end learning check that needs no download (the twin of
``scripts/e2e_sanity.py``): synthesize 24 tones, binarize them, train the
FastDiff vocoder 2,500 steps, vocode the test split and score it.

    python -m fastdiff_tpu_torch.scripts.e2e_sanity [workdir] [--device cpu]
        [--max_updates N] [--hparams 'k=v,...']

The flow and hparams are the JAX script's: 24 tones of 1.5 s (two
partials under a slow AM and a little noise, seeded with numpy), the
``VocoderBinarizer`` (pickle shards and the C++ loader's v2 files),
``FastDiffTask`` + ``Trainer.fit`` for 2,500 updates (lr 4e-4, batches of
16 x 12,800 samples, bf16, clip_grad_norm 1, validation every 1,250), then
``Trainer.test`` and the MCD and mel-L2 of the test split against the
ground truth (``utils/metrics.py``). On the card ``use_pallas_block: auto``
trains on ``ncl_sr`` and vocodes on ``ncl``. It prints the validation loss
at each validation, the training wall time, MCD and mel-L2, and exits 1
unless the final validation loss is at most ``VAL_BOUND``.

The JAX script's docstring records, on its TPU, a validation loss of 1.0 ->
0.136 by 2,500 steps and a test-split MCD of ~14.7 dB / mel-L2 ~4.7 (the
set is tiny and synthetic: the point is that the pipeline learns and the
inference path reproduces it). ``--max_updates`` and ``--hparams`` (small
widths) are for a rehearsal on the CPU; ``chip_smoke.py``'s phase 32 runs
a 300-update cut on the same data.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time

import numpy as np

from fastdiff_tpu_torch.config import AudioConfig
from fastdiff_tpu_torch.data import native_io
from fastdiff_tpu_torch.data.binarizer import VocoderBinarizer
from fastdiff_tpu_torch.models.fastdiff import checked_device
from fastdiff_tpu_torch.training.task import FastDiffTask
from fastdiff_tpu_torch.training.trainer import Trainer
from fastdiff_tpu_torch.utils import audio_io, metrics
from fastdiff_tpu_torch.utils.hparams import apply_overrides

SR = 22050
N_TONES = 24
TONE_SECONDS = 1.5
VAL_BOUND = 0.25


def write_tones(root: str) -> None:
    """The JAX script's 24 tones under ``<root>/raw`` and their
    ``metadata_phone.csv``."""
    os.makedirs(f"{root}/raw", exist_ok=True)
    rng = np.random.default_rng(0)
    with open(f"{root}/metadata_phone.csv", "w") as f:
        f.write("item_name,wav_fn\n")
        for i in range(N_TONES):
            t = np.arange(int(SR * TONE_SECONDS)) / SR
            f1, f2 = 150 + 20 * i, 300 + 35 * i
            am = 0.5 + 0.3 * np.sin(2 * np.pi * 2.0 * t + i)
            wav = (am * (0.45 * np.sin(2 * np.pi * f1 * t)
                         + 0.25 * np.sin(2 * np.pi * f2 * t))
                   + 0.01 * rng.standard_normal(len(t))).astype(np.float32)
            fn = f"{root}/raw/u{i:02d}.wav"
            audio_io.save_wav(wav, fn, SR)
            f.write(f"u{i:02d},{fn}\n")


def sanity_hparams(root: str) -> dict:
    """The JAX script's hparams, rooted at ``root``."""
    return {
        "processed_data_dir": root, "binary_data_dir": f"{root}/binary",
        "work_dir": f"{root}/work",
        "audio_sample_rate": SR, "audio_num_mel_bins": 80,
        "fft_size": 1024, "hop_size": 256, "win_size": 1024,
        "fmin": 80, "fmax": 7600, "test_num": 4,
        "audio_channels": 1, "inner_channels": 32, "cond_channels": 80,
        "upsample_ratios": [8, 8, 4], "lvc_layers_each_block": 4,
        "lvc_kernel_size": 3, "kpnet_hidden_channels": 64,
        "kpnet_conv_size": 3, "dropout": 0.0,
        "diffusion_step_embed_dim_in": 128,
        "diffusion_step_embed_dim_mid": 512,
        "diffusion_step_embed_dim_out": 512,
        "use_weight_norm": True, "compute_dtype": "bfloat16",
        "conv_impl": "dot",
        "T": 1000, "beta_0": 1e-6, "beta_T": 0.01, "noise_schedule": "",
        "N": 4,
        "max_updates": 2500, "max_samples": 12800, "max_sentences": 16,
        "max_valid_sentences": 2, "val_check_interval": 1250,
        "num_sanity_val_steps": 1, "tb_log_interval": 250,
        "lr": 4e-4, "weight_decay": 0, "scheduler": "none",
        "optimizer_adam_beta1": 0.9, "optimizer_adam_beta2": 0.98,
        "clip_grad_norm": 1, "accumulate_grad_batches": 1,
        "num_ckpt_keep": 1, "save_best": True, "seed": 0,
        "valid_monitor_key": "val_loss", "valid_monitor_mode": "min",
        "endless_ds": True, "eval_max_batches": 2, "amp": True,
        "binarization_args": {"with_wav": True, "shuffle": False},
        "pre_align_args": {}, "N_PROC": 1,
        "test_input_dir": "", "test_mel_dir": "", "use_wav": True,
        "save_gt": True, "gen_dir_name": "", "resume_from_checkpoint": 0,
        "load_ckpt": "",
        "binarizer_cls": "fastdiff_tpu.data.binarizer.VocoderBinarizer",
        "train_set_name": "train", "valid_set_name": "valid",
        "test_set_name": "test",
    }


def validation_losses(work_dir: str) -> list:
    """(step, val loss) of every in-loop validation, from the trainer's
    ``tb_logs/metrics.jsonl``."""
    path = os.path.join(work_dir, "tb_logs", "metrics.jsonl")
    rows = []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if "val/loss" in rec:
                rows.append((rec["step"], rec["val/loss"]))
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("workdir", nargs="?", default=os.path.join(
        tempfile.gettempdir(), "fastdiff_e2e_sanity"))
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--max_updates", type=int, default=None)
    parser.add_argument("--hparams", default="")
    args = parser.parse_args(argv)
    device = checked_device(args.device)
    root = args.workdir
    write_tones(root)
    hp = sanity_hparams(root)
    if args.max_updates is not None:
        hp["max_updates"] = args.max_updates
        hp["val_check_interval"] = max(1, args.max_updates // 2)
    if args.hparams:
        apply_overrides(hp, args.hparams)
    VocoderBinarizer(hp).process()

    task = FastDiffTask(hp, device=device)
    trainer = Trainer(task, hp["work_dir"])
    t0 = time.time()
    result = trainer.fit()
    train_s = time.time() - t0
    for step, loss in validation_losses(hp["work_dir"]):
        print(f"| val loss @ {step}: {loss:.4f}", flush=True)
    final = float(result["val"]["loss"])
    print(f"training done in {train_s / 60:.1f} min ({train_s:.1f} s, "
          f"{result['step']} updates, route {task.route}, "
          f"{native_io.BATCHES} batches from the native loader), final val "
          f"loss {final:.4f}", flush=True)

    trainer.test()
    gen_dir = max(glob.glob(f"{hp['work_dir']}/generated_*"),
                  key=lambda d: int(d.split("generated_")[1].split("_")[0]))
    cfg = AudioConfig()
    mcds, msds = [], []
    for pred_fn in sorted(glob.glob(f"{gen_dir}/*_pred.wav")):
        pred, _ = audio_io.load_wav(pred_fn)
        gt, _ = audio_io.load_wav(pred_fn.replace("_pred", "_gt"))
        mcds.append(metrics.mcd(pred, gt, cfg))
        msds.append(metrics.mel_spectral_distance(pred, gt, cfg))
    print(f"test-split quality after {result['step']} steps: MCD "
          f"{np.mean(mcds):.2f} dB, mel-L2 {np.mean(msds):.2f} "
          f"({len(mcds)} utterances)", flush=True)
    if not final <= VAL_BOUND:
        print(f"FAIL: final val loss {final:.4f} > {VAL_BOUND}", flush=True)
        return 1
    print(f"OK: final val loss {final:.4f} <= {VAL_BOUND}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
