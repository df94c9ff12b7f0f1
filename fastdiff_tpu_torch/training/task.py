"""FastDiff vocoder training task (``fastdiff_tpu/training/task.py``), for the
fastdiff denoiser.

``build_state`` makes the trainable model (``FastDiff(cfg, train_route=...)``
on the task's device, weight norm as parameters), its optimizer and the
step counter; ``train_step`` runs the loss (``diffusion/losses.py``), its
gradients and one optimizer update; ``val_step`` the loss alone. As in the
JAX task, a step whose loss or any gradient is not finite changes neither
the parameters nor the optimizer state, and the step counter still
advances. The route of the LVC blocks comes from ``use_pallas_block``
(``models/fastdiff.py:resolve_train_route``).

The data pipeline is ``data/dataset.py``, plain numpy copied from the JAX
package (binarized ``<split>`` files and ``<split>_lengths.npy`` under
``binary_data_dir``, random aligned crops of ``max_samples``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from fastdiff_tpu_torch.config import AudioConfig, DiffusionConfig, TrainConfig
from fastdiff_tpu_torch.data.dataset import VocoderDataset, train_batch_iterator
from fastdiff_tpu_torch.diffusion import schedules
from fastdiff_tpu_torch.diffusion.losses import theta_timestep_loss
from fastdiff_tpu_torch.models.fastdiff import (FastDiff, checked_device,
                                                num_params,
                                                resolve_train_route)
from fastdiff_tpu_torch.training.checkpoint import load_checkpoint
from fastdiff_tpu_torch.training.optim import AdamW, global_norm
from fastdiff_tpu_torch.vocoders.fastdiff_vocoder import \
    model_config_from_hparams


@dataclasses.dataclass
class TrainState:
    """What a training run carries from step to step; ``ema`` maps each
    parameter name to its moving average when ``ema_decay`` > 0."""
    model: FastDiff
    optimizer: AdamW
    step: int = 0
    ema: Optional[Dict[str, torch.Tensor]] = None


class FastDiffTask:
    """Conditional diffusion vocoder task (mel -> waveform)."""

    def __init__(self, hparams: dict, device="cuda"):
        denoiser = str(hparams.get("denoiser", "fastdiff"))
        if denoiser != "fastdiff":
            raise NotImplementedError(
                f"denoiser {denoiser!r} is not ported (ROADMAP.md queue 1, "
                "the model zoo); the port trains the fastdiff denoiser")
        self.hparams = hparams
        self.device = checked_device(device)
        self.diff_cfg = DiffusionConfig.from_hparams(hparams)
        self.audio_cfg = AudioConfig.from_hparams(hparams)
        self.train_cfg = TrainConfig.from_hparams(hparams)
        self.model_cfg = model_config_from_hparams(hparams)
        self.route = resolve_train_route(hparams, self.device)
        hyper = schedules.compute_hyperparams_given_schedule(
            schedules.linear_beta_schedule(self.diff_cfg))
        self.alpha = torch.as_tensor(hyper.alpha, dtype=torch.float32,
                                     device=self.device)
        # EMA of the parameters (0 disables), as in the JAX task
        self.ema_decay = float(hparams.get("ema_decay", 0.0) or 0.0)

    # -- state -------------------------------------------------------------
    def build_state(self, seed: int | None = None) -> TrainState:
        seed = self.train_cfg.seed if seed is None else seed
        model = FastDiff(self.model_cfg, seed=seed, device=self.device,
                         train_route=self.route)
        print(f"| model params: {num_params(model) / 1e6:.3f}M "
              f"(route {self.route})")
        load_ckpt = self.hparams.get("load_ckpt", "")
        if load_ckpt:
            model.load_state_dict(load_checkpoint(
                load_ckpt, map_location=self.device)["params"])
            print(f"| loaded checkpoint: {load_ckpt}")
        state = TrainState(model, AdamW(model.parameters(), self.train_cfg))
        if self.ema_decay > 0:
            state.ema = {k: p.detach().clone()
                         for k, p in model.named_parameters()}
        return state

    # -- train/val ---------------------------------------------------------
    def _batch(self, batch: dict) -> tuple:
        return tuple(torch.as_tensor(np.asarray(batch[k]), dtype=torch.float32,
                                     device=self.device)
                     for k in ("mels", "wavs"))

    def loss(self, model, batch: dict, generator=None, ts=None, z=None):
        mels, wavs = self._batch(batch)
        return theta_timestep_loss(model, mels, wavs, self.alpha,
                                   generator=generator, ts=ts, z=z)

    def train_step(self, state: TrainState, batch: dict,
                   generator: torch.Generator | None = None, *,
                   ts=None, z=None) -> dict:
        """One update in place; returns loss, global gradient norm and
        ``nonfinite`` (1.0 when the update was skipped) as 0-dim tensors."""
        model = state.model
        params = list(model.parameters())
        loss = self.loss(model, batch, generator, ts, z)
        grads = torch.autograd.grad(loss, params)
        finite = torch.stack([torch.isfinite(loss)] +
                             [torch.isfinite(g).all() for g in grads]).all()
        if bool(finite):
            state.optimizer.step(grads)
        state.step += 1
        if state.ema is not None:
            d = self.ema_decay
            with torch.no_grad():
                for name, p in model.named_parameters():
                    e = state.ema[name]
                    e.copy_(e * d + p * (1 - d))
        return {"loss": loss.detach(), "grad_norm": global_norm(grads),
                "nonfinite": (~finite).float()}

    @torch.no_grad()
    def val_step(self, state: TrainState, batch: dict,
                 generator: torch.Generator | None = None) -> dict:
        return {"loss": self.loss(state.model, batch, generator)}

    # -- dataloaders -------------------------------------------------------
    def _max_frames(self) -> int:
        return self.train_cfg.max_samples // int(self.hparams["hop_size"])

    def train_dataloader(self):
        ds = VocoderDataset(self.hparams,
                            self.hparams.get("train_set_name", "train"),
                            shuffle=True)
        return train_batch_iterator(
            ds, self.train_cfg.max_sentences, self._max_frames(),
            seed=self.train_cfg.seed, endless=self.train_cfg.endless_ds)

    def val_dataloader(self):
        if getattr(self, "_val_ds", None) is None:
            self._val_ds = VocoderDataset(
                self.hparams, self.hparams.get("valid_set_name", "valid"),
                shuffle=False)
        return train_batch_iterator(
            self._val_ds, max(1, self.train_cfg.max_valid_sentences),
            self._max_frames(), seed=self.train_cfg.seed, endless=False)
