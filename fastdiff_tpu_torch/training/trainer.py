"""Training loop: updates to ``max_updates``, validation, checkpoints
(``fastdiff_tpu/training/trainer.py``).

- sanity validation over ``num_sanity_val_steps`` batches before training;
- a loop over the task's batches until ``max_updates``;
- scalars every ``tb_log_interval`` updates (``tb_logs/metrics.jsonl``, and
  TensorBoard when it is installed);
- validation and a checkpoint every ``val_check_interval`` updates and at
  the end, the newest ``num_ckpt_keep`` kept and the best validation loss
  tracked (``training/checkpoint.py``); after each validation within the
  loop, the figures of a task that has ``val_figures`` (FastSpeech 2's
  GT-vs-predicted mels) go to ``tb_logs/figures/`` as PNGs, and a failure
  to draw them prints a warning and training goes on;
- ``restore`` resumes from the newest checkpoint in ``work_dir`` (or the
  step ``resume_from_checkpoint`` pins): parameters, optimizer state, step,
  best score and EMA;
- ``test`` restores the newest checkpoint (or runs the task's seed weights
  when there is none), prefers the EMA weights, takes the task's
  ``inference_state_dict`` of them (weight norm fused for FastDiff) and
  vocodes the task's test items, one utterance at a time, into
  ``generated_<step>_<gen_dir_name>``, printing each one's real-time
  factor and their mean.

Random draws come from a ``torch.Generator`` on the task's device, seeded
from ``seed`` and the step the run starts at (in ``test``, from ``seed``).

Data parallel (``parallel/mesh.py``): every rank runs the loop and
restores the same checkpoint; only rank 0 logs scalars and figures and
saves checkpoints, as in JAX.
"""

from __future__ import annotations

import functools
import itertools
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

from fastdiff_tpu_torch.diffusion.sampler import inference_generator
from fastdiff_tpu_torch.parallel.mesh import make_mesh
from fastdiff_tpu_torch.training import checkpoint as ckpt
from fastdiff_tpu_torch.utils.logging_utils import MeterBank, ScalarLogger


class Trainer:
    def __init__(self, task, work_dir: str):
        self.task = task
        self.cfg = task.train_cfg
        self.work_dir = work_dir or "checkpoints/default"
        os.makedirs(self.work_dir, exist_ok=True)
        self.is_main = make_mesh().rank == 0
        self.logger = ScalarLogger(os.path.join(self.work_dir, "tb_logs"),
                                   enabled=self.is_main)
        self.best_val: Optional[float] = None

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.task.device).manual_seed(seed)

    # -- resume ------------------------------------------------------------
    def restore(self, state):
        pin = int(self.task.hparams.get("resume_from_checkpoint", 0) or 0)
        path, step = ckpt.get_last_checkpoint(self.work_dir, pin or None)
        if path is None:
            return state, 0
        saved = ckpt.load_checkpoint(path, map_location=self.task.device)
        state.model.load_state_dict(saved["params"])
        state.optimizer.load_state_dict(saved["opt_state"])
        state.step = int(saved["step"])
        if state.ema is not None and "ema" in saved:
            state.ema = saved["ema"]
        bv = float(saved.get("best_val", 0.0))
        self.best_val = bv if bv > 0 else None
        print(f"| restored checkpoint {os.path.basename(path)} (step {step})")
        return state, state.step

    # -- validation --------------------------------------------------------
    def evaluate(self, state, max_batches: Optional[int] = None,
                 step: Optional[int] = None) -> dict:
        """Average the task's ``val_step`` over the validation batches.
        With ``step`` (not the sanity pass) the figures of the first batch
        are logged too, when the task draws any."""
        meters = MeterBank()
        gen = self._generator(self.cfg.seed + 777)
        loader = self.task.val_dataloader()
        if max_batches is not None and max_batches >= 0:
            loader = itertools.islice(loader, max_batches)
        n, first_batch = 0, None
        for batch in loader:
            out = self.task.val_step(state, batch, gen)
            meters.update({k: float(v) for k, v in out.items()},
                          n=batch["mels"].shape[0])
            if first_batch is None:
                first_batch = batch
            n += 1
        if (step is not None and first_batch is not None
                and hasattr(self.task, "val_figures")):
            try:
                for tag, fig in self.task.val_figures(
                        state, first_batch).items():
                    self.logger.log_figure(tag, fig, step)
            except Exception as e:   # figures must never kill training
                print(f"| WARNING: val_figures failed: {e}")
        return meters.averages() if n else {"loss": float("nan")}

    def _maybe_save(self, state, step: int, val_metrics: dict):
        if not self.is_main:
            return
        monitor = val_metrics.get(
            self.cfg.valid_monitor_key.replace("val_", ""), None)
        is_best = False
        if monitor is not None and np.isfinite(monitor) and self.cfg.save_best:
            better = (self.best_val is None or
                      (monitor < self.best_val
                       if self.cfg.valid_monitor_mode == "min"
                       else monitor > self.best_val))
            if better:
                self.best_val = float(monitor)
                is_best = True
        saved = {"params": state.model.state_dict(),
                 "opt_state": state.optimizer.state_dict(),
                 "step": step, "best_val": float(self.best_val or 0.0)}
        if state.ema is not None:
            saved["ema"] = state.ema
        path = ckpt.save_checkpoint(self.work_dir, step, saved,
                                    num_keep=self.cfg.num_ckpt_keep,
                                    is_best=is_best)
        print(f"| saved {os.path.basename(path)}"
              + (" (best)" if is_best else ""))

    # -- main loop ---------------------------------------------------------
    def fit(self, state=None) -> dict:
        task = self.task
        if state is None:
            state = task.build_state()
        state, start_step = self.restore(state)

        if self.cfg.num_sanity_val_steps:
            sanity = self.evaluate(
                state, max_batches=max(0, self.cfg.num_sanity_val_steps))
            print(f"| sanity val: {sanity}")

        gen = self._generator(self.cfg.seed + start_step)
        meters = MeterBank()
        t_last = time.time()
        step = start_step
        try:
            for batch in task.train_dataloader():
                if step >= self.cfg.max_updates:
                    break
                metrics = task.train_step(state, batch, gen)
                step = state.step

                if step % self.cfg.tb_log_interval == 0:
                    metrics = {k: float(v) for k, v in metrics.items()}
                    dt = time.time() - t_last
                    t_last = time.time()
                    metrics["steps_per_sec"] = self.cfg.tb_log_interval / dt
                    meters.update(metrics)
                    self.logger.log(metrics, step, prefix="tr/")
                    extras = " ".join(
                        f"{k}={v:.4f}" for k, v in metrics.items()
                        if k not in ("loss", "steps_per_sec"))
                    print(f"| step {step}: loss={metrics['loss']:.4f} "
                          f"{extras} {metrics['steps_per_sec']:.2f} it/s")
                    sys.stdout.flush()

                if step % self.cfg.val_check_interval == 0:
                    val = self.evaluate(state, self.cfg.eval_max_batches,
                                        step=step)
                    self.logger.log(val, step, prefix="val/")
                    print(f"| validation @ {step}: {val}")
                    self._maybe_save(state, step, val)
        except KeyboardInterrupt:
            print("| KeyboardInterrupt: saving checkpoint before exit.")
            self._maybe_save(state, step, {})
            raise

        val = self.evaluate(state, self.cfg.eval_max_batches)
        self._maybe_save(state, step, val)
        return {"state": state, "step": step, "val": val}

    # -- inference ---------------------------------------------------------
    def test(self, state=None, noise=None) -> list:
        """Vocode the task's test items (``fastdiff_tpu/training/
        trainer.py:test``); returns each item's ``test_step`` result.

        The sampler's draws come from one generator on the task's device,
        seeded from ``seed``; ``noise(index, audio_length)``, when given,
        returns the draws of the index-th utterance to inject instead."""
        task = self.task
        if state is None:
            state = task.build_state()
        state, step = self.restore(state)
        trained = (state.ema if state.ema is not None
                   else state.model.state_dict())
        sampler = task.make_test_sampler(task.inference_state_dict(trained),
                                         task.sampler_constants())
        gen_dir = os.path.join(
            self.work_dir,
            f"generated_{step}_{task.hparams.get('gen_dir_name', '')}")
        generator = inference_generator(self.cfg.seed, task.device)
        results = []
        for i, sample in enumerate(task.test_dataloader()):
            draws = None if noise is None else functools.partial(noise, i)
            res = task.test_step(sample, sampler, gen_dir, generator, draws)
            print(f"| generated {res['item_name']}: rtf={res['rtf']:.4f}")
            results.append(res)
        if results:
            rtf = float(np.mean([r["rtf"] for r in results[1:]] or
                                [results[0]["rtf"]]))
            print(f"| mean RTF (excl. first/compile): {rtf:.4f} "
                  f"({1.0 / max(rtf, 1e-9):.1f}x realtime)")
        return results
