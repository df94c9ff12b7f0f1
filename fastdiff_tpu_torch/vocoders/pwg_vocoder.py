"""PWG registry vocoder: mel -> waveform through the ParallelWaveGAN
generator (``fastdiff_tpu/vocoders/pwg_vocoder.py``), registered as ``pwg``.

``vocoder_ckpt`` names a released generator checkpoint of the reference
(``state_dict`` / ``model`` / ``generator`` nesting and ``generator.``
prefixes unwrapped, then ``models/pwg.py:convert_pwg_state_dict``, weight
norm fused); without one, or when the path does not exist, it warns and
runs seed-0 weights, as the FastDiff vocoder does. ``spec2wav`` draws the
noise signal of the target length from the vocoder's ``torch.Generator``
(seeded from ``seed``) on ``device``, the CUDA card unless the caller
names another, and runs the generator conditioned on the mel.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from fastdiff_tpu_torch.models.pwg import PWG as PWGModel
from fastdiff_tpu_torch.models.pwg import PWGConfig, convert_pwg_state_dict
from fastdiff_tpu_torch.vocoders.base import BaseVocoder, register_vocoder


def released_generator(blob: dict) -> dict:
    """The generator's flat state_dict inside a released PWG checkpoint."""
    sd = blob.get("state_dict", blob)
    if "model" in sd:
        sd = sd["model"]
    if "generator" in sd:
        sd = sd["generator"]
    return {k[len("generator."):] if k.startswith("generator.") else k: v
            for k, v in sd.items()}


@register_vocoder
class PWG(BaseVocoder):
    def __init__(self, hparams: dict | None = None, device="cuda"):
        super().__init__(hparams, device)
        hp = self.hparams
        self.cfg = PWGConfig(
            aux_context_window=int(hp.get("aux_context_window", 2)),
            compute_dtype=str(hp.get("compute_dtype", "bfloat16")))
        self.hop = int(np.prod(self.cfg.upsample_scales))
        ckpt = hp.get("vocoder_ckpt", "")
        if ckpt and os.path.exists(ckpt):
            model = PWGModel(self.cfg, seed=None)
            model.load_state_dict(convert_pwg_state_dict(released_generator(
                torch.load(ckpt, map_location="cpu", weights_only=True)),
                self.cfg))
            print(f"| loaded PWG generator: {ckpt}")
        else:
            print("| WARNING: no vocoder_ckpt; PWG vocoder runs with random "
                  "weights.")
            model = PWGModel(self.cfg, seed=0)
        self.model = model.to(self.device).eval()
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(hp.get("seed", 1234)))

    @torch.inference_mode()
    def spec2wav(self, mel: np.ndarray, **kwargs) -> np.ndarray:
        """mel (T, n_mels) -> waveform (T * hop,) float32."""
        mel = torch.from_numpy(np.asarray(mel, np.float32))[None].to(
            self.device)
        noise = torch.randn((1, mel.shape[1] * self.hop, 1),
                            generator=self.generator, device=self.device)
        return self.model(noise, mel)[0, :, 0].cpu().numpy()
