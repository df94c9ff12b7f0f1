"""Autoregressive MoL / MoG WaveNet vocoder task
(``fastdiff_tpu/training/armol_task.py``): teacher-forced mixture-NLL
training on the binarized (mel, wav) crops the diffusion vocoder trains
on, and fold / unfold AR synthesis in ``test_step``.

The ``Trainer`` contract of the other tasks: ``build_state`` (a
``TrainState``: ``MoLWaveNet`` on the task's device, the optax-semantics
``AdamW``, the step), ``train_step`` (a step whose loss or any gradient is
not finite changes neither the parameters nor the optimizer state, and
the step counter still advances), ``val_step``, the loaders,
``inference_state_dict``, and ``sampler_constants`` / ``make_test_sampler``
returning None: there is no diffusion sampler. ``make_test_sampler`` loads
the weights into the model ``test_step`` generates with
(``models/wavenet_mol.py:wavenet_generate``, a CUDA graph on the card).
``micro_lj_armol.yaml`` names it as ``task_cls``. Under a process group
the model runs under ``DistributedDataParallel`` on the rank's rows of
each batch (``parallel/mesh.py``).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from fastdiff_tpu_torch.config import AudioConfig, TrainConfig
from fastdiff_tpu_torch.data.dataset import (VocoderDataset,
                                             infer_item_iterator,
                                             train_batch_iterator)
from fastdiff_tpu_torch.models.fastdiff import checked_device, num_params
from fastdiff_tpu_torch.models.wavenet_mol import (MoLWaveNet,
                                                   MoLWaveNetConfig,
                                                   wavenet_generate,
                                                   wavenet_mol_loss)
from fastdiff_tpu_torch.parallel import mesh as meshlib
from fastdiff_tpu_torch.training.optim import AdamW
from fastdiff_tpu_torch.training.task import TrainState
from fastdiff_tpu_torch.utils import audio_io


class MoLWaveNetTask:
    """AR WaveNet vocoder task (teacher-forced NLL training)."""

    def __init__(self, hparams: dict, device="cuda"):
        self.hparams = hparams
        self.device = checked_device(device)
        self.mesh = meshlib.make_mesh(device=self.device)
        self.audio_cfg = AudioConfig.from_hparams(hparams)
        self.train_cfg = TrainConfig.from_hparams(hparams)
        self.model_cfg = MoLWaveNetConfig.from_hparams(hparams)
        assert self.model_cfg.hop == int(hparams["hop_size"]), (
            "wn_upsample_scales must multiply to hop_size",
            self.model_cfg.upsample_scales, hparams["hop_size"])
        self.test_model = None

    # -- state -------------------------------------------------------------
    def build_state(self, seed: int | None = None) -> TrainState:
        seed = self.train_cfg.seed if seed is None else seed
        model = MoLWaveNet(self.model_cfg, seed=seed, device=self.device)
        print(f"| model params: {num_params(model) / 1e6:.3f}M")
        return TrainState(model, AdamW(model.parameters(), self.train_cfg),
                          ddp=meshlib.data_parallel(model, self.mesh))

    # -- train/val ---------------------------------------------------------
    def loss(self, model: MoLWaveNet, batch: dict) -> torch.Tensor:
        mels, wavs = (torch.as_tensor(np.asarray(batch[k]),
                                      dtype=torch.float32, device=self.device)
                      for k in ("mels", "wavs"))
        return wavenet_mol_loss(model, wavs, mels)

    def train_step(self, state: TrainState, batch: dict,
                   generator: torch.Generator | None = None) -> dict:
        """One update in place; returns the loss and ``nonfinite`` (1.0 when
        the update was skipped) as 0-dim tensors. The loss draws nothing,
        so ``generator`` is unused."""
        params = list(state.model.parameters())
        loss = self.loss(state.net, meshlib.shard_batch(batch, self.mesh))
        # zeros for weights the loss does not reach (the last block's out
        # conv), as JAX's gradients hold them; averaged over the ranks
        # under DDP
        grads = meshlib.gradients(loss, params, state.ddp)
        loss = meshlib.mean_over_ranks(loss.detach(), self.mesh)
        finite = torch.stack([torch.isfinite(loss)] +
                             [torch.isfinite(g).all() for g in grads]).all()
        if bool(finite):
            state.optimizer.step(grads)
        state.step += 1
        return {"loss": loss.detach(), "nonfinite": (~finite).float()}

    @torch.no_grad()
    def val_step(self, state: TrainState, batch: dict,
                 generator: torch.Generator | None = None) -> dict:
        return {"loss": self.loss(state.model, batch)}

    # -- dataloaders (the diffusion vocoder's binarized data) ----------------
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

    def test_dataloader(self):
        ds = VocoderDataset(self.hparams,
                            self.hparams.get("test_set_name", "test"))
        return infer_item_iterator(ds)

    # -- inference ---------------------------------------------------------
    def inference_state_dict(self, saved: dict) -> dict:
        return saved.get("params", saved)

    def sampler_constants(self):
        """No diffusion schedule: AR synthesis."""
        return None

    def make_test_sampler(self, state_dict: dict, constants) -> None:
        """Load ``state_dict`` into the model ``test_step`` generates with;
        there is no sampler (the trainer contract's None)."""
        model = MoLWaveNet(self.model_cfg, seed=None)
        model.load_state_dict(state_dict)
        self.test_model = model.to(self.device).eval()
        return None

    def test_step(self, sample: Dict, sampler, gen_dir: str,
                  generator: torch.Generator,
                  noise: Optional[Callable] = None) -> Dict:
        """AR synthesis of one utterance (``wavenet_generate``, folds of
        ``wn_fold_target`` + 2 x ``wn_fold_overlap`` samples) and its wavs;
        ``sampler`` is unused. ``noise(audio_length)``, when given, returns
        the mixture draws to inject (``wavenet_mol.make_draws``' layout
        over the folds)."""
        if self.test_model is None:
            raise RuntimeError("make_test_sampler loads the weights "
                               "test_step generates with; call it first")
        mel = torch.from_numpy(np.asarray(sample["mels"], np.float32))
        hop = int(self.hparams["hop_size"])
        t0 = time.perf_counter()
        wav = wavenet_generate(
            self.test_model, mel, generator,
            target=int(self.hparams.get("wn_fold_target", 12800)),
            overlap=int(self.hparams.get("wn_fold_overlap", 512)),
            draws=None if noise is None else noise(mel.shape[1] * hop))
        gen_time = time.perf_counter() - t0
        os.makedirs(gen_dir, exist_ok=True)
        item_name = sample["item_name"]
        sr = self.audio_cfg.sample_rate
        wav_out = wav / max(1e-9, np.abs(wav).max())
        audio_io.save_wav(wav_out,
                          os.path.join(gen_dir, f"{item_name}_pred.wav"), sr)
        if "wavs" in sample and self.hparams.get("save_gt", True):
            gt = np.asarray(sample["wavs"])[0, :, 0]
            gt = gt / max(1e-9, np.abs(gt).max())
            audio_io.save_wav(gt, os.path.join(gen_dir,
                                               f"{item_name}_gt.wav"), sr)
        rtf = gen_time * sr / max(len(wav), 1)
        return {"item_name": item_name, "rtf": rtf, "gen_seconds": gen_time,
                "audio_seconds": len(wav) / sr}
