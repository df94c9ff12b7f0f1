"""The configuration dataclasses of ``fastdiff_tpu/config.py``, copied.

``ModelConfig``, ``DiffusionConfig``, ``AudioConfig`` and ``TrainConfig``
with the same fields, defaults and ``from_hparams`` readers, which cast
every value as JAX's do (a config's ``lr: 2e-4`` is the string ``'2e-4'``
until ``float`` reads it). ``ModelConfig`` leaves out the route fields
(``use_pallas_block``, ``use_pallas_down``) and JAX's ``conv_impl`` with the
JAX package's resolvers: the port reads the routes from the hparams with
``resolve_infer_route``, ``resolve_down_kernel`` and ``resolve_train_route``
in ``models/fastdiff.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """FastDiff denoiser hyperparameters (reference: FastDiff_model.py:13-26)."""
    audio_channels: int = 1
    inner_channels: int = 32
    cond_channels: int = 80
    upsample_ratios: Tuple[int, ...] = (8, 8, 4)
    lvc_layers_each_block: int = 4
    lvc_kernel_size: int = 3
    kpnet_hidden_channels: int = 64
    kpnet_conv_size: int = 3
    dropout: float = 0.0
    diffusion_step_embed_dim_in: int = 128
    diffusion_step_embed_dim_mid: int = 512
    diffusion_step_embed_dim_out: int = 512
    use_weight_norm: bool = True
    compute_dtype: str = "bfloat16"

    @property
    def cond_hop_lengths(self) -> Tuple[int, ...]:
        """Per-LVC-block conditioning hop = cumulative product of ratios."""
        hops = []
        hop = 1
        for r in self.upsample_ratios:
            hop *= r
            hops.append(hop)
        return tuple(hops)

    @property
    def total_hop(self) -> int:
        hop = 1
        for r in self.upsample_ratios:
            hop *= r
        return hop

    @classmethod
    def from_hparams(cls, hp: dict) -> "ModelConfig":
        return cls(
            audio_channels=int(hp.get("audio_channels", 1)),
            inner_channels=int(hp.get("inner_channels", 32)),
            cond_channels=int(hp.get("cond_channels", 80)),
            upsample_ratios=tuple(int(r) for r in
                                  hp.get("upsample_ratios", (8, 8, 4))),
            lvc_layers_each_block=int(hp.get("lvc_layers_each_block", 4)),
            lvc_kernel_size=int(hp.get("lvc_kernel_size", 3)),
            kpnet_hidden_channels=int(hp.get("kpnet_hidden_channels", 64)),
            kpnet_conv_size=int(hp.get("kpnet_conv_size", 3)),
            dropout=float(hp.get("dropout", 0.0)),
            diffusion_step_embed_dim_in=int(
                hp.get("diffusion_step_embed_dim_in", 128)),
            diffusion_step_embed_dim_mid=int(
                hp.get("diffusion_step_embed_dim_mid", 512)),
            diffusion_step_embed_dim_out=int(
                hp.get("diffusion_step_embed_dim_out", 512)),
            use_weight_norm=bool(hp.get("use_weight_norm", True)),
            compute_dtype=str(hp.get("compute_dtype", "bfloat16")),
        )


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """Training diffusion schedule (reference: config/base.yaml:38-42)."""
    T: int = 1000
    beta_0: float = 1e-6
    beta_T: float = 0.01

    @classmethod
    def from_hparams(cls, hp: dict) -> "DiffusionConfig":
        return cls(T=int(hp.get("T", 1000)),
                   beta_0=float(hp.get("beta_0", 1e-6)),
                   beta_T=float(hp.get("beta_T", 0.01)))


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    """Mel front-end parameters (reference: config/base.yaml:4-16,
    data_gen/tts/data_gen_utils.py:93-147)."""
    sample_rate: int = 22050
    num_mels: int = 80
    fft_size: int = 1024
    hop_size: int = 256
    win_size: int = 1024
    fmin: float = 80.0
    fmax: float = 7600.0
    mel_eps: float = 1e-6
    mel_compression: str = "log10"   # "log10" (pwg) | "ln" (tacotron)
    griffin_lim_iters: int = 60

    @classmethod
    def from_hparams(cls, hp: dict) -> "AudioConfig":
        return cls(
            sample_rate=int(hp.get("audio_sample_rate", 22050)),
            num_mels=int(hp.get("audio_num_mel_bins", 80)),
            fft_size=int(hp.get("fft_size", 1024)),
            hop_size=int(hp.get("hop_size", 256)),
            win_size=int(hp.get("win_size", 1024)),
            fmin=float(hp.get("fmin", 80)),
            fmax=float(hp.get("fmax", 7600)),
            mel_eps=float(hp.get("mel_eps", 1e-6)),
            mel_compression=str(hp.get("mel_compression", "log10")),
            griffin_lim_iters=int(hp.get("griffin_lim_iters", 60)),
        )


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Trainer knobs (reference: config/base.yaml:48-157)."""
    max_updates: int = 1000000
    max_samples: int = 25600
    max_sentences: int = 20
    max_valid_sentences: int = 1
    val_check_interval: int = 2000
    num_sanity_val_steps: int = 2
    lr: float = 2e-4
    weight_decay: float = 0.0
    scheduler: str = "none"
    adam_beta1: float = 0.9
    adam_beta2: float = 0.98
    clip_grad_norm: float = 1.0
    accumulate_grad_batches: int = 1
    tb_log_interval: int = 100
    num_ckpt_keep: int = 3
    save_best: bool = True
    valid_monitor_key: str = "val_loss"
    valid_monitor_mode: str = "min"
    seed: int = 1234
    amp: bool = True
    eval_max_batches: int = -1
    endless_ds: bool = True

    @classmethod
    def from_hparams(cls, hp: dict) -> "TrainConfig":
        max_sentences = int(hp.get("max_sentences", 20))
        max_valid = int(hp.get("max_valid_sentences", 1))
        if max_valid == -1:  # reference: -1 -> use the train batch size
            max_valid = max_sentences
        return cls(
            max_updates=int(hp.get("max_updates", 1000000)),
            max_samples=int(hp.get("max_samples", 25600)),
            max_sentences=max_sentences,
            max_valid_sentences=max_valid,
            val_check_interval=int(hp.get("val_check_interval", 2000)),
            num_sanity_val_steps=int(hp.get("num_sanity_val_steps", 2)),
            lr=float(hp.get("lr", 2e-4)),
            weight_decay=float(hp.get("weight_decay", 0.0)),
            scheduler=str(hp.get("scheduler", "none")),
            adam_beta1=float(hp.get("optimizer_adam_beta1", 0.9)),
            adam_beta2=float(hp.get("optimizer_adam_beta2", 0.98)),
            clip_grad_norm=float(hp.get("clip_grad_norm", 1.0)),
            accumulate_grad_batches=int(hp.get("accumulate_grad_batches", 1)),
            tb_log_interval=int(hp.get("tb_log_interval", 100)),
            num_ckpt_keep=int(hp.get("num_ckpt_keep", 3)),
            save_best=bool(hp.get("save_best", True)),
            valid_monitor_key=str(hp.get("valid_monitor_key", "val_loss")),
            valid_monitor_mode=str(hp.get("valid_monitor_mode", "min")),
            seed=int(hp.get("seed", 1234)),
            amp=bool(hp.get("amp", True)),
            eval_max_batches=int(hp.get("eval_max_batches", -1)),
            endless_ds=bool(hp.get("endless_ds", True)),
        )
