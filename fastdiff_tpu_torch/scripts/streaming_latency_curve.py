"""The streaming vocoder's latency against its quality (the twin of
``scripts/streaming_latency_curve.py``) on the weights of a checkpoint
directory the port's ``Trainer`` wrote.

    python -m fastdiff_tpu_torch.scripts.streaming_latency_curve CKPT_DIR
        [--device cuda]

``CKPT_DIR`` holds the run's ``config.yaml`` (``run.py`` writes it beside
its checkpoints) and ``model_ckpt_steps_*.ckpt``; the newest checkpoint's
parameters, weight norm fused, run on the route ``use_pallas_block``
picks, through the N = 4 graph sampler. For each (chunk, halo) setting it
vocodes every utterance of the config's binarized ``valid`` split with the
``StreamingVocoder`` and compares it with the quality reference, the full
utterance through the same sampler, its mel edge-padded to a multiple of
128 frames and the waveform cut back (identical weights, no chunk seams;
each call's generator seeded 0, as JAX reuses its key 0). One row per
setting: the finalization latency (chunk - halo) * hop / sr in ms and the
mean MCD, mel-L2 and MR-STFT of ``utils/metrics.py`` against the
reference. ``load`` and ``curve`` are its parts
(``tests/test_torch_script_twins.py`` runs them at a small width on the
CPU; ``chip_smoke.py`` phase 34 on the learning check's checkpoint).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from fastdiff_tpu_torch.config import AudioConfig, DiffusionConfig
from fastdiff_tpu_torch.data.indexed_dataset import IndexedDataset
from fastdiff_tpu_torch.diffusion import schedules
from fastdiff_tpu_torch.diffusion.sampler import (inference_generator,
                                                  make_param_sampler)
from fastdiff_tpu_torch.serving.streaming_vocoder import StreamingVocoder
from fastdiff_tpu_torch.training.checkpoint import (get_last_checkpoint,
                                                    load_checkpoint)
from fastdiff_tpu_torch.training.task import FastDiffTask
from fastdiff_tpu_torch.utils.hparams import set_hparams
from fastdiff_tpu_torch.utils.metrics import (mcd, mel_spectral_distance,
                                              multi_resolution_stft_distance)

SETTINGS = [                      # (chunk_frames, halo_frames)
    (256, 16),                    # production default (~2.8 s latency)
    (128, 16),                    # ~1.5 s
    (64, 12),                     # ~600 ms
    (48, 8),                      # low_latency preset (~464 ms)
    (32, 8),                      # ~270 ms (halo = RF/2, quality floor probe)
]
BUCKET = 128


def load(ckpt_dir: str, device="cuda") -> tuple:
    """(hparams, sampler(generator, mel (1, F, n_mels), length), valid
    mels, checkpoint step) of ``ckpt_dir``."""
    hp = set_hparams(config=os.path.join(ckpt_dir, "config.yaml"),
                     exp_name="", hparams_str="", print_hparams=False,
                     global_hparams=False)
    task = FastDiffTask(hp, device=device)
    path, step = get_last_checkpoint(ckpt_dir)
    if path is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    saved = load_checkpoint(path, map_location=task.device)
    model = task.inference_model(task.inference_state_dict(saved["params"]))
    hyper = schedules.compute_hyperparams_given_schedule(
        schedules.linear_beta_schedule(DiffusionConfig.from_hparams(hp)))
    const = schedules.sampler_constants_for_schedule(
        schedules.noise_schedule_for_steps(4), hyper)
    psampler = make_param_sampler(model, const)

    def sampler(generator, mel, audio_length):
        return psampler(None, generator, mel, audio_length)

    ds = IndexedDataset(os.path.join(hp["binary_data_dir"], "valid"))
    mels = [np.asarray(ds[i]["mel"], np.float32) for i in range(len(ds))]
    return hp, sampler, mels, step


def curve(sampler, mels: list, hop: int, audio_cfg: AudioConfig, device,
          settings=SETTINGS) -> list:
    """One row per (chunk, halo): {"chunk", "halo", "latency_ms", "mcd",
    "mel_l2", "mr_stft", "pairs"}; the metrics are means over the
    utterances of each streamed waveform against its reference, both cut
    to the shorter (``pairs`` holds those arrays)."""
    refs = []
    for mel in mels:
        frames = mel.shape[0]
        padded = -(-frames // BUCKET) * BUCKET
        mel_p = np.pad(mel, ((0, padded - frames), (0, 0)), mode="edge")
        wav = sampler(inference_generator(0, device),
                      torch.from_numpy(mel_p)[None], padded * hop)
        refs.append(wav[0, : frames * hop, 0].cpu().numpy())
    rows = []
    for chunk, halo in settings:
        pairs = []
        for mel, ref in zip(mels, refs):
            voc = StreamingVocoder(sampler, hop, chunk_frames=chunk,
                                   halo_frames=halo,
                                   generator=inference_generator(0, device))
            out = np.concatenate([voc.feed(mel), voc.finish()])
            n = min(len(out), len(ref))
            pairs.append((out[:n], ref[:n]))
        rows.append({
            "chunk": chunk, "halo": halo,
            "latency_ms": (chunk - halo) * hop / audio_cfg.sample_rate * 1e3,
            "mcd": float(np.mean([mcd(o, r, audio_cfg) for o, r in pairs])),
            "mel_l2": float(np.mean([mel_spectral_distance(o, r, audio_cfg)
                                     for o, r in pairs])),
            "mr_stft": float(np.mean([multi_resolution_stft_distance(o, r)
                                      for o, r in pairs])),
            "pairs": pairs})
    return rows


def main(argv=None) -> list:
    parser = argparse.ArgumentParser()
    parser.add_argument("ckpt_dir")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    hp, sampler, mels, step = load(args.ckpt_dir, args.device)
    audio_cfg = AudioConfig.from_hparams(hp)
    print(f"| {len(mels)} validation utterances, model {args.ckpt_dir} "
          f"step {step}", flush=True)
    rows = curve(sampler, mels, audio_cfg.hop_size, audio_cfg, args.device)
    print("| chunk halo latency_ms   MCD   mel-L2  MR-STFT   (vs batch path)")
    for row in rows:
        print(f"| {row['chunk']:5d} {row['halo']:4d} "
              f"{row['latency_ms']:10.0f} {row['mcd']:6.2f} "
              f"{row['mel_l2']:7.3f} {row['mr_stft']:8.3f}", flush=True)
    return rows


if __name__ == "__main__":
    main()
