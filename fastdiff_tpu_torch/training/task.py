"""FastDiff vocoder training task (``fastdiff_tpu/training/task.py``).

``denoiser`` picks the epsilon network: ``fastdiff`` (the default, and
any name but the two below, as in JAX), ``wavenet`` (``models/wavenet.py``,
DiffWave-style) or ``pwg`` (``models/pwg.py:PWGDiffusion``). ``build_state``
makes the trainable model (``FastDiff(cfg, train_route=...)`` on the task's
device, weight norm as parameters; or the zoo denoiser), its optimizer and
the step counter; ``load_ckpt`` loads a released checkpoint of the
reference (``utils/ckpt_import.py``, the fastdiff denoiser) or a checkpoint
of the port's ``Trainer`` into it. ``train_step`` runs the loss (``diffusion/losses.py``), its gradients
and one optimizer update; ``val_step`` the loss alone. As in the JAX task,
a step whose loss or any gradient is not finite changes neither the
parameters nor the optimizer state, and the step counter still advances.
The route of the LVC blocks comes from ``use_pallas_block``
(``models/fastdiff.py:resolve_train_route``); the zoo denoisers have no
LVC block, resolve no route and launch no kernel (their ops are plain
PyTorch, as JAX's are plain jnp).

Inference (``Trainer.test``): ``test_dataloader`` yields the test split, or
the wavs of ``test_input_dir`` / the ``.npy`` mels of ``test_mel_dir``
featurized by the binarizer; ``inference_model`` loads fused inference
weights into a ``FastDiff`` on the route ``resolve_infer_route`` picks (the
score network of the BDDM search too; a zoo denoiser as it trains, weight
norm resolved on each call), and ``make_test_sampler`` returns
``make_param_sampler`` over it, one CUDA graph per padded length;
``test_step`` edge-pads the mel to a multiple of ``infer_frame_bucket``
frames (128), so utterances of one bucket replay one graph, trims the
waveform back to frames * hop, peak-normalizes it, writes
``<item>_pred.wav`` (and ``_gt.wav``) and reports the real-time factor.

The data pipeline is ``data/dataset.py``, plain numpy copied from the JAX
package (binarized ``<split>`` files and ``<split>_lengths.npy`` under
``binary_data_dir``, random aligned crops of ``max_samples``; the C++ mmap
loader where the split has v2 files).

Data parallel (``parallel/mesh.py``, a process group under ``torchrun``):
the trainable module runs wrapped in ``DistributedDataParallel``
(``TrainState.ddp``); at world size W > 1 each rank keeps its contiguous
rows of the global batch and of the global batch's draws of t and z (JAX's
``dp`` sharding of one global key's draws), DDP averages the gradients,
and the reported losses are means over the ranks.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from fastdiff_tpu_torch.config import (AudioConfig, DiffusionConfig,
                                       ModelConfig, TrainConfig)
from fastdiff_tpu_torch.data.dataset import (VocoderDataset,
                                             infer_item_iterator,
                                             train_batch_iterator)
from fastdiff_tpu_torch.diffusion import schedules
from fastdiff_tpu_torch.diffusion.losses import theta_timestep_loss
from fastdiff_tpu_torch.diffusion.sampler import (ParamGraphSampler,
                                                  constants_for_hparams,
                                                  make_param_sampler)
from fastdiff_tpu_torch.models.fastdiff import (FastDiff, checked_device,
                                                num_params,
                                                resolve_down_kernel,
                                                resolve_infer_route,
                                                resolve_train_route)
from fastdiff_tpu_torch.models.pwg import PWGConfig, PWGDiffusion
from fastdiff_tpu_torch.models.wavenet import WaveNet, WaveNetConfig
from fastdiff_tpu_torch.parallel import mesh as meshlib
from fastdiff_tpu_torch.training.checkpoint import load_checkpoint
from fastdiff_tpu_torch.training.optim import AdamW, global_norm
from fastdiff_tpu_torch.utils import audio_io, ckpt_import
from fastdiff_tpu_torch.vocoders import fastdiff_vocoder


# the zoo denoisers: ``denoiser`` name -> (config class, module)
ZOO = {"wavenet": (WaveNetConfig, WaveNet), "pwg": (PWGConfig, PWGDiffusion)}


@dataclasses.dataclass
class TrainState:
    """What a training run carries from step to step (the FastDiff and the
    FastSpeech 2 tasks); ``ema`` maps each parameter name to its moving
    average when ``ema_decay`` > 0; ``ddp`` is ``model`` wrapped in
    ``DistributedDataParallel`` when a process group is up (the module the
    train step runs), else None."""
    model: torch.nn.Module
    optimizer: AdamW
    step: int = 0
    ema: Optional[Dict[str, torch.Tensor]] = None
    ddp: Optional[torch.nn.Module] = None

    @property
    def net(self) -> torch.nn.Module:
        """The module a train step calls: ``ddp`` when there is one."""
        return self.model if self.ddp is None else self.ddp


class FastDiffTask:
    """Conditional diffusion vocoder task (mel -> waveform)."""

    def __init__(self, hparams: dict, device="cuda"):
        self.hparams = hparams
        self.device = checked_device(device)
        self.diff_cfg = DiffusionConfig.from_hparams(hparams)
        self.audio_cfg = AudioConfig.from_hparams(hparams)
        self.train_cfg = TrainConfig.from_hparams(hparams)
        self.denoiser_type = str(hparams.get("denoiser", "fastdiff"))
        self.zoo = ZOO.get(self.denoiser_type)
        if self.zoo is not None:
            self.model_cfg = self.zoo[0].from_hparams(hparams)
            self.route = None
        else:
            self.model_cfg = ModelConfig.from_hparams(hparams)
            self.route = resolve_train_route(hparams, self.device)
        hyper = schedules.compute_hyperparams_given_schedule(
            schedules.linear_beta_schedule(self.diff_cfg))
        self.alpha = torch.as_tensor(hyper.alpha, dtype=torch.float32,
                                     device=self.device)
        # EMA of the parameters (0 disables), as in the JAX task
        self.ema_decay = float(hparams.get("ema_decay", 0.0) or 0.0)
        self.mesh = meshlib.make_mesh(device=self.device)
        meshlib.warn_replicated(self.train_cfg.max_sentences, self.mesh)

    # -- state -------------------------------------------------------------
    def build_state(self, seed: int | None = None) -> TrainState:
        seed = self.train_cfg.seed if seed is None else seed
        if self.zoo is not None:
            model = self.zoo[1](self.model_cfg, seed=seed, device=self.device)
        else:
            model = FastDiff(self.model_cfg, seed=seed, device=self.device,
                             train_route=self.route)
        print(f"| model params: {num_params(model) / 1e6:.3f}M "
              f"({self.denoiser_type}, route {self.route})")
        load_ckpt = self.hparams.get("load_ckpt", "")
        if load_ckpt:
            model.load_state_dict(self._load_external_params(load_ckpt))
        state = TrainState(model, AdamW(model.parameters(), self.train_cfg),
                           ddp=meshlib.data_parallel(model, self.mesh))
        if self.ema_decay > 0:
            state.ema = {k: p.detach().clone()
                         for k, p in model.named_parameters()}
        return state

    def _load_external_params(self, path: str) -> dict:
        """The trainable state_dict in ``load_ckpt``: a released checkpoint
        of the reference (weight norm kept) or the ``params`` of a port
        ``Trainer`` checkpoint."""
        saved = load_checkpoint(path, map_location=self.device)
        released = ckpt_import.released_state_dict(saved)
        if released is not None and self.zoo is None:
            print(f"| loaded released checkpoint: {path}")
            return ckpt_import.trainable_state_dict(released, self.model_cfg)
        print(f"| loaded checkpoint: {path}")
        return saved.get("params", saved)

    # -- train/val ---------------------------------------------------------
    def _batch(self, batch: dict) -> tuple:
        return tuple(torch.as_tensor(np.asarray(batch[k]), dtype=torch.float32,
                                     device=self.device)
                     for k in ("mels", "wavs"))

    def loss(self, model, batch: dict, generator=None, ts=None, z=None):
        """The loss of ``batch``; at world size > 1 of this rank's rows of
        it, and of the draws made (or given) for the whole batch."""
        mels, wavs = self._batch(batch)
        if self.mesh.world_size > 1:
            b = wavs.shape[0]
            if ts is None:
                ts = torch.randint(0, self.alpha.shape[0], (b, 1, 1),
                                   generator=generator, device=wavs.device)
            if z is None:
                z = torch.randn(wavs.shape, generator=generator,
                                device=wavs.device, dtype=wavs.dtype)
            rows = meshlib.shard_rows(b, self.mesh)
            mels, wavs, ts, z = mels[rows], wavs[rows], ts[rows], z[rows]
        return theta_timestep_loss(model, mels, wavs, self.alpha,
                                   generator=generator, ts=ts, z=z)

    def train_step(self, state: TrainState, batch: dict,
                   generator: torch.Generator | None = None, *,
                   ts=None, z=None) -> dict:
        """One update in place; returns loss, global gradient norm and
        ``nonfinite`` (1.0 when the update was skipped) as 0-dim tensors."""
        model = state.model
        params = list(model.parameters())
        loss = self.loss(state.net, batch, generator, ts, z)
        # zeros for weights the loss does not reach (a zoo denoiser's last
        # residual conv), as JAX's gradients hold them; averaged over the
        # ranks under DDP
        grads = meshlib.gradients(loss, params, state.ddp)
        loss = meshlib.mean_over_ranks(loss.detach(), self.mesh)
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
        return {"loss": meshlib.mean_over_ranks(
            self.loss(state.model, batch, generator), self.mesh)}

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

    def test_dataloader(self):
        ds = VocoderDataset(self.hparams,
                            self.hparams.get("test_set_name", "test"))
        return infer_item_iterator(ds)

    # -- inference ---------------------------------------------------------
    def sampler_constants(self) -> schedules.SamplerConstants:
        return constants_for_hparams(self.hparams)

    def inference_state_dict(self, saved: dict) -> dict:
        """The weights ``inference_model`` takes, from a loaded checkpoint,
        a trainable state_dict or its EMA: weight norm fused for the
        fastdiff denoiser (``vocoders/fastdiff_vocoder.py:
        inference_state_dict``); a zoo denoiser's as they are."""
        if self.zoo is not None:
            return saved.get("params", saved)
        return fastdiff_vocoder.inference_state_dict(saved, self.model_cfg)

    def inference_model(self, state_dict: dict) -> torch.nn.Module:
        """The inference denoiser on the task's device, in eval mode,
        holding ``state_dict``, called as ``model(x, mel, t)``: the
        counterpart of JAX's ``param_apply_fn``. For fastdiff a ``FastDiff``
        on the route ``use_pallas_block`` picks (``resolve_infer_route``,
        ``resolve_down_kernel``) with fused weights; a zoo denoiser is its
        training module."""
        if self.zoo is not None:
            model = self.zoo[1](self.model_cfg, seed=None)
        else:
            model = FastDiff(self.model_cfg, seed=None,
                             infer_route=resolve_infer_route(self.hparams),
                             down_kernel=resolve_down_kernel(self.hparams))
        model.load_state_dict(state_dict)
        return model.to(self.device).eval()

    def make_test_sampler(self, state_dict: dict,
                          constants: schedules.SamplerConstants
                          ) -> ParamGraphSampler:
        """The graph sampler over ``inference_model(state_dict)``:
        ``sampler(None, generator, mel, audio_length, *, noise=None)``."""
        return make_param_sampler(self.inference_model(state_dict),
                                  constants)

    def test_step(self, sample: Dict, sampler: ParamGraphSampler,
                  gen_dir: str, generator: torch.Generator,
                  noise: Optional[Callable] = None) -> Dict:
        """Generate one utterance and write its wavs (FastDiff.py:60-119).

        The mel is edge-padded to a multiple of ``infer_frame_bucket``
        frames, so the sampler keeps one graph per bucket, and the waveform
        is trimmed back to frames * hop. ``noise(audio_length)``, when
        given, returns the draws to inject in place of ``generator``'s."""
        mel_np = np.asarray(sample["mels"])
        frames = mel_np.shape[1]
        bucket = int(self.hparams.get("infer_frame_bucket", 128))
        padded = ((frames + bucket - 1) // bucket) * bucket
        if padded != frames:
            mel_np = np.pad(mel_np, ((0, 0), (0, padded - frames), (0, 0)),
                            mode="edge")
        mel = torch.from_numpy(mel_np).to(self.device)
        hop = int(self.hparams["hop_size"])
        length = padded * hop
        t0 = time.perf_counter()
        wav = sampler(None, generator, mel, length,
                      noise=None if noise is None else noise(length))
        wav = wav[0, : frames * hop, 0].cpu().numpy()
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
        rtf = gen_time * sr / len(wav)
        return {"item_name": item_name, "rtf": rtf, "gen_seconds": gen_time,
                "audio_seconds": len(wav) / sr, "frames": frames,
                "padded_frames": padded, "captures": sampler.captures}
