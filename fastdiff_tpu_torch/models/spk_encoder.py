"""Speaker-embedding extractor: log-mel -> 256-d d-vector
(``fastdiff_tpu/models/spk_encoder.py``).

    log-mel (B, T, n_mels) -> 3x [conv1d k=5 /2 + relu] -> temporal
    statistics pooling (mean ++ std) -> dense -> L2-normalized (B, 256)

The std is the population one (``correction=0``, as ``jnp.var``) with
``+ 1e-5`` under the square root. Without ``spk_embed_ckpt`` the network
runs with fixed seeded weights drawn by ``torch.Generator`` with the JAX
package's distributions; they are the port's own draws, not JAX's
``PRNGKey(20260816)`` ones (``models/bridge.py:zoo_params_from_jax``
carries a JAX tree across). ``spk_embed_ckpt`` names a checkpoint that
``training/spk_task.py:train_spk_encoder``'s caller saved through
``training/checkpoint.py`` (its ``params``) or a bare state_dict.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fastdiff_tpu_torch.models.fastdiff import checked_device
from fastdiff_tpu_torch.ops.nn import uniform_init_

EMBED_DIM = 256
_HIDDEN = 128
SEED = 20260816


class SpeakerEncoder(nn.Module):
    """``forward(mel (B, T, n_mels)) -> (B, 256)`` unit-norm embeddings
    (JAX's ``spk_encoder_apply``); ``embed`` is the binarizer's numpy
    call."""

    def __init__(self, ckpt_path: str = "", seed: int | None = SEED,
                 n_mels: int = 80, device="cuda"):
        super().__init__()
        self.conv0 = nn.Conv1d(n_mels, _HIDDEN, 5, stride=2, padding=2)
        self.conv1 = nn.Conv1d(_HIDDEN, _HIDDEN, 5, stride=2, padding=2)
        self.conv2 = nn.Conv1d(_HIDDEN, _HIDDEN, 5, stride=2, padding=2)
        self.proj = nn.Linear(2 * _HIDDEN, EMBED_DIM)
        if seed is not None:
            uniform_init_(self, torch.Generator().manual_seed(seed))
        if ckpt_path:
            from fastdiff_tpu_torch.training.checkpoint import load_checkpoint
            saved = load_checkpoint(ckpt_path, map_location="cpu")
            self.load_state_dict(saved.get("params", saved))
        self.to(checked_device(device))

    @property
    def device(self) -> torch.device:
        return self.proj.weight.device

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = mel.float().transpose(1, 2)
        for conv in (self.conv0, self.conv1, self.conv2):
            x = F.relu(conv(x))
        mean = x.mean(dim=2)
        std = torch.sqrt(x.var(dim=2, correction=0) + 1e-5)
        emb = self.proj(torch.cat([mean, std], dim=-1))
        return emb / torch.linalg.norm(emb, dim=-1, keepdim=True)

    @torch.no_grad()
    def embed(self, mel: np.ndarray) -> np.ndarray:
        """mel (T, n_mels) -> (256,) float32; fewer than 8 frames are
        edge-padded to 8."""
        mel = np.asarray(mel, np.float32)
        if mel.shape[0] < 8:
            mel = np.pad(mel, ((0, 8 - mel.shape[0]), (0, 0)), mode="edge")
        emb = self(torch.from_numpy(mel)[None].to(self.device))
        return emb[0].cpu().numpy()


@functools.lru_cache(maxsize=2)
def get_speaker_encoder(ckpt_path: str = "", device="cuda") -> SpeakerEncoder:
    return SpeakerEncoder(ckpt_path, device=device).eval()
