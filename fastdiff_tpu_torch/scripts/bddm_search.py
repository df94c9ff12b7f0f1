"""BDDM noise-schedule search, end to end against a score network
(``scripts/bddm_search.py`` on the port).

Train the phi noise predictor (``diffusion/noise_predictor.py``) against a
FastDiff score network, run the reverse schedule search for N = 8, 6, 4
and 3 from the published tables' largest beta, and score each searched
schedule and its published counterpart (reference: modules/FastDiff/task/
FastDiff.py:76-93) by the objective metrics of one held-out utterance:

    python -m fastdiff_tpu_torch.scripts.bddm_search --exp_name micro_lj \
        --config fastdiff_tpu/configs/micro_lj.yaml [--phi_steps 2000] \
        [--hparams 'binary_data_dir=...'] [--device cpu]

Steps: restore the score network with ``Trainer.restore`` from
``checkpoints/<exp_name>`` (none there: the seed state at step 0), fuse
weight norm (its EMA when it has one) into the inference ``FastDiff``
(``FastDiffTask.inference_model``, the route ``use_pallas_block`` picks);
train phi ``--phi_steps`` steps with ``torch.optim.Adam(lr=1e-4)`` (optax's
``adam(1e-4)``: b1 0.9, b2 0.999, eps 1e-8 outside the square root) on
``task.train_dataloader()``; search; sample each schedule through
``make_param_sampler`` and score it with ``utils/metrics.py`` (MCD,
MR-STFT, PESQ against the utterance's wav).

Writes ``<work_dir>/bddm_schedules.json`` and a markdown report,
``<work_dir>/bddm_report.md`` unless ``--out`` names another file.
``--device`` defaults to ``cuda`` and raises without a card.
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from fastdiff_tpu_torch.config import AudioConfig
from fastdiff_tpu_torch.diffusion import schedules
from fastdiff_tpu_torch.diffusion.noise_predictor import (
    NoisePredictor, phi_train_step, search_noise_schedule)
from fastdiff_tpu_torch.diffusion.sampler import (inference_generator,
                                                  make_param_sampler)
from fastdiff_tpu_torch.training.task import FastDiffTask
from fastdiff_tpu_torch.training.trainer import Trainer
from fastdiff_tpu_torch.utils import metrics
from fastdiff_tpu_torch.utils.hparams import set_hparams
from fastdiff_tpu_torch.vocoders.fastdiff_vocoder import inference_state_dict

PUBLISHED = {   # reference FastDiff.py:76-93 (BDDM-derived)
    8: [6.69e-06, 1.0e-05, 1.0e-05, 0.0001, 0.001, 0.01, 0.1, 0.35],
    6: [1.7838445955931093e-06, 2.7984189728158526e-05,
        0.00043231004383414984, 0.006634317338466644,
        0.09357017278671265, 0.6000000238418579],
    4: [3.2176e-4, 2.5743e-3, 2.5376e-2, 7.0414e-1],
    3: [9.0e-05, 9.0e-03, 6.0e-01],
}


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)


def _report(results: dict, exp_name: str, step: int, phi_steps: int,
            device: str) -> str:
    fmt = lambda xs: "[" + ", ".join(f"{x:.2e}" for x in xs) + "]"
    lines = [
        "# BDDM noise-schedule search (PyTorch port)", "",
        f"Score net: `{exp_name}` at step {step} (EMA when it has one, "
        f"weight norm fused) on {device}. Phi predictor trained "
        f"{phi_steps} steps on the same corpus "
        "(fastdiff_tpu_torch/diffusion/noise_predictor.py).", "",
        "| N | schedule | MCD dB | MR-STFT | PESQ |",
        "|---|---|---|---|---|",
    ]
    for n, r in sorted(results.items()):
        s, p = r["searched"], r["published"]
        lines.append(f"| {n} (searched, {len(s['schedule'])} steps) | "
                     f"{fmt(s['schedule'])} | {s['mcd']:.2f} | "
                     f"{s['mrstft']:.3f} | {s['pesq']:.2f} |")
        lines.append(f"| {n} (published) | {fmt(p['schedule'])} | "
                     f"{p['mcd']:.2f} | {p['mrstft']:.3f} | {p['pesq']:.2f} |")
    lines += ["",
              "Published rows are the reference's BDDM-derived tables "
              "(FastDiff.py:76-93) run through the same sampler and "
              "metrics on the same held-out utterance."]
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="fastdiff_tpu/configs/micro_lj.yaml")
    ap.add_argument("--exp_name", default="micro_lj")
    ap.add_argument("--hparams", default="")
    ap.add_argument("--phi_steps", type=int, default=2000)
    ap.add_argument("--out", default="",
                    help="markdown report (default <work_dir>/bddm_report.md)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    hp = set_hparams(config=args.config, exp_name=args.exp_name,
                     hparams_str=args.hparams, print_hparams=False,
                     global_hparams=False)
    task = FastDiffTask(hp, device=args.device)
    dev = task.device
    work_dir = hp.get("work_dir") or f"checkpoints/{args.exp_name}"
    trainer = Trainer(task, work_dir)
    state, step = trainer.restore(task.build_state())
    print(f"| score net restored at step {step}")
    trained = (state.ema if state.ema is not None
               else state.model.state_dict())
    score = task.inference_model(inference_state_dict(trained,
                                                      task.model_cfg))
    del state, trained

    # -- phi training --------------------------------------------------------
    phi = NoisePredictor(seed=0, device=dev)
    opt = torch.optim.Adam(phi.parameters(), lr=1e-4)
    generator = torch.Generator(device=dev).manual_seed(1)
    t0 = time.time()
    for i, batch in enumerate(task.train_dataloader()):
        if i >= args.phi_steps:
            break
        loss = phi_train_step(phi, opt, score, _tensor(batch["mels"], dev),
                              _tensor(batch["wavs"], dev), task.alpha,
                              generator=generator)
        if i % 200 == 0:
            print(f"| phi step {i}: loss={float(loss):.4f} "
                  f"({time.time() - t0:.0f}s)")

    # -- search + evaluate ---------------------------------------------------
    val_batch = next(iter(task.val_dataloader()))
    mel = _tensor(val_batch["mels"][:1], dev)
    audio_len = mel.shape[1] * task.model_cfg.total_hop
    gt = np.asarray(val_batch["wavs"])[0, :, 0]
    acfg = AudioConfig.from_hparams(hp)
    hyper = schedules.compute_hyperparams_given_schedule(
        schedules.linear_beta_schedule(task.diff_cfg))

    def eval_schedule(sched):
        const = schedules.sampler_constants_for_schedule(
            np.asarray(sched, np.float64), hyper)
        sampler = make_param_sampler(score, const)
        wav = sampler(None, inference_generator(7, dev), mel, audio_len)
        wav = wav[0, :, 0].cpu().numpy()
        return {
            "schedule": [float(b) for b in np.asarray(sched)],
            "mcd": metrics.mcd(wav, gt, acfg),
            "mrstft": metrics.multi_resolution_stft_distance(wav, gt),
            "pesq": metrics.pesq_mos(gt, wav, acfg.sample_rate),
        }

    search_gen = torch.Generator(device=dev).manual_seed(2)
    results = {}
    for n in (8, 6, 4, 3):
        searched = search_noise_schedule(
            phi, score, mel, hyper, audio_len, max_steps=n,
            beta_start=PUBLISHED[n][-1], alpha_start=0.3, rho=1e-9,
            generator=search_gen)
        print(f"| N={n}: searched {len(searched)} steps: "
              f"{[f'{b:.2e}' for b in searched]}")
        if len(searched) == 0:
            continue
        results[n] = {"searched": eval_schedule(searched),
                      "published": eval_schedule(PUBLISHED[n])}

    with open(os.path.join(work_dir, "bddm_schedules.json"), "w") as f:
        json.dump(results, f, indent=1)
    out = args.out or os.path.join(work_dir, "bddm_report.md")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        f.write(_report(results, args.exp_name, step, args.phi_steps,
                        str(dev)))
    print(f"| wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
