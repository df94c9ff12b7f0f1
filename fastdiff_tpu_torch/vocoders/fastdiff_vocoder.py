"""FastDiff as a vocoder: mel -> waveform through the N-step sampler
(``fastdiff_tpu/vocoders/fastdiff_vocoder.py``), registered as ``fastdiff``
in ``vocoders/base.py``'s registry (``FastDiff`` is its JAX name, so a
dotted ``vocoder`` path to JAX's class resolves to it).

Built from a plain hparams dict (cast by ``ModelConfig.from_hparams``) on
``device``, the CUDA card unless the caller names another (no card raises).
``vocoder_ckpt`` names a released checkpoint of the reference
(``utils/ckpt_import.py``), a ``FastDiff`` state_dict saved with
``torch.save`` (a JAX tree converts with ``models/bridge.py:
params_from_jax``) or a checkpoint of the port's ``Trainer``; weight norm is
fused on load. Without one, or when the path does not exist, the model runs
with the seed-0 random weights, as the JAX vocoder does. ``spec2wav`` runs
the graph sampler (``diffusion/sampler.py:make_param_sampler``: a frame
count's first request runs eagerly, its second captures a CUDA graph that
later ones replay, at most ``max_graphs`` frame counts kept) with the
vocoder's generator, seeded from ``seed``; a non-zero
``chunked_infer_frames`` vocodes through
``serving/chunked_vocoder.py:ChunkedVocoder`` around that sampler, all
chunks of an utterance in one call, so the graph key is the chunk count.
``use_pallas_block`` and
``use_pallas_down`` pick the route as the JAX vocoder's
``inference_model_config`` does (``models/fastdiff.py:resolve_infer_route``
and ``resolve_down_kernel``): "auto" / "ncl" run the NCL route (K3, K1),
"ncl_fh" the fused-head route (K5), true the NWC route (K6, K7, and with
``use_pallas_down`` K8), false the plain route (no kernel).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from fastdiff_tpu_torch.config import ModelConfig
from fastdiff_tpu_torch.diffusion.sampler import (constants_for_hparams,
                                                  inference_generator,
                                                  make_param_sampler)
from fastdiff_tpu_torch.models import bridge
from fastdiff_tpu_torch.models.fastdiff import FastDiff as FastDiffModel
from fastdiff_tpu_torch.models.fastdiff import (resolve_down_kernel,
                                                resolve_infer_route)
from fastdiff_tpu_torch.serving.chunked_vocoder import ChunkedVocoder
from fastdiff_tpu_torch.utils import ckpt_import
from fastdiff_tpu_torch.vocoders.base import BaseVocoder, register_vocoder


def inference_state_dict(saved: dict, cfg: ModelConfig) -> dict:
    """The inference ``FastDiff`` state_dict in a loaded checkpoint: a
    released checkpoint of the reference through ``utils/ckpt_import.py``,
    a bare state_dict as it is, or the ``params`` of a ``Trainer``
    checkpoint (the trainable model's v / g / bias, or anything keyed like
    it, such as its EMA) with weight norm fused as the JAX vocoder fuses it
    (``bridge.params_to_jax`` then ``params_from_jax``)."""
    released = ckpt_import.released_state_dict(saved)
    if released is not None:
        return ckpt_import.inference_state_dict(released, cfg)
    state = saved.get("params", saved)
    if not any(k.endswith(".v") for k in state):
        return state
    return bridge.params_from_jax(bridge.params_to_jax(state, cfg), cfg)


class FastDiffVocoder(BaseVocoder):
    def __init__(self, hparams: dict | None = None, device="cuda",
                 max_graphs: int = 8):
        super().__init__(hparams, device)
        hp = self.hparams
        self.model_cfg = ModelConfig.from_hparams(hp)
        self.hop = self.model_cfg.total_hop
        self.constants = constants_for_hparams(hp)
        self.route = resolve_infer_route(hp)
        route = dict(infer_route=self.route,
                     down_kernel=resolve_down_kernel(hp))
        ckpt = hp.get("vocoder_ckpt", "")
        if ckpt and os.path.exists(ckpt):
            model = FastDiffModel(self.model_cfg, seed=None, **route)
            model.load_state_dict(inference_state_dict(
                torch.load(ckpt, map_location="cpu", weights_only=True),
                self.model_cfg))
        else:
            print("| WARNING: no vocoder_ckpt given; FastDiff vocoder runs "
                  "with random weights.")
            model = FastDiffModel(self.model_cfg, seed=0, **route)
        self.model = model.to(self.device).eval()
        self.sampler = make_param_sampler(self.model, self.constants,
                                          max_graphs=max_graphs)
        self.generator = inference_generator(int(hp.get("seed", 1234)),
                                             self.device)
        chunk = int(hp.get("chunked_infer_frames", 0) or 0)
        self.chunked = None
        if chunk:
            self.chunked = ChunkedVocoder(self.sample, hop_size=self.hop,
                                          chunk_frames=chunk)

    def sample(self, generator, mel: torch.Tensor,
               audio_length: int) -> torch.Tensor:
        """The graph sampler on the model's current weights:
        ``sample(generator, mel, audio_length) -> (B, L, 1)``."""
        return self.sampler(None, generator, mel, audio_length)

    def spec2wav(self, mel: np.ndarray) -> np.ndarray:
        """mel (T, n_mels) -> waveform (T * hop,) float32."""
        mel = np.asarray(mel, np.float32)
        if self.chunked is not None:
            return self.chunked.vocode(mel, generator=self.generator)
        wav = self.sample(self.generator, torch.from_numpy(mel)[None],
                          mel.shape[0] * self.hop)
        return wav[0, :, 0].cpu().numpy()


register_vocoder(FastDiffVocoder, "fastdiff")
FastDiff = FastDiffVocoder
