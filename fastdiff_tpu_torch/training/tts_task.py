"""FastSpeech 2 training task: text -> mel (``fastdiff_tpu/training/
tts_task.py``).

``FastSpeech2Task(hparams, device=...)`` sizes the model from the hparams
(``FS2Config.from_hparams``; ``vocab_size`` from the hparams or from
``binary_data_dir/phone_set.json`` plus the three reserved ids, else 100)
on the CUDA card unless the caller names another device.

- ``build_state`` returns a ``TrainState``: the seed-weight model on the
  task's device, the port's ``AdamW`` (global-norm clip, the ``rsqrt``
  schedule with ``warmup_updates`` and the model's hidden size, as JAX's
  ``make_optimizer``) and step 0; the ``Trainer`` restores and saves it.
- ``train_step`` runs the teacher-mode forward (``mel2ph``, f0 / uv or
  coarse pitch, energy from the batch), ``fastspeech2_loss`` with the
  hparams' ``mel_loss``, lambdas and ``pitch_loss``, the backward and one
  optimizer update, and returns the loss terms as floats (``loss`` is
  ``total``). Nothing is drawn and the model has no dropout, so the step is
  deterministic; as in JAX there is no skip of non-finite steps and no EMA.
- data parallel (a process group, ``parallel/mesh.py``): the module runs
  wrapped in ``DistributedDataParallel``, each of W ranks keeps its rows of
  the padded batch, and the loss terms are means over the ranks.
- ``val_step`` is the loss under ``no_grad``; ``val_figures`` draws the
  ground-truth and predicted mels of the first validation batch side by
  side (``utils/plot.py``), which the ``Trainer`` logs as PNGs.
- ``train_dataloader`` / ``val_dataloader`` read the binarized records of
  ``data/tts_binarizer.py`` (items without ``phone`` skipped) and pad each
  batch with ``collate_tts`` to a multiple of 8 tokens and 32 frames.
- ``synthesize`` is the text-to-wav entry, and ``infer_to_wav`` writes what
  it returns: the forward of ``state.model`` in inference mode (predicted
  durations, the mel padded to ``max_frames``; on the card replayed from a
  CUDA graph of the sentence's token count, ``tts/acoustic_graphs.py``),
  trimmed to its valid frames, then the vocoder ``tts_vocoder`` builds on the first call and
  keeps, so its graph sampler and generator carry over from call to call.
  That is the registry's (``hparams['vocoder']``, FastDiff by default) at
  the mel's own frame count, as JAX's unpadded ``infer_to_wav`` (JAX builds
  a vocoder per call): each new frame count is a new graph shape. With
  ``infer_frame_bucket`` set, the registry FastDiff's denoiser runs behind
  a ``BatchedVocoder`` instead: the mel is zero-padded to a multiple of the
  bucket, which is what FastSpeech 2 itself gives past its valid frames, so
  a corpus's lengths replay a few graphs (one a bucket, every bucket up to
  ``max_frames`` kept), and the waveform is trimmed back.
- Under ``torch.profiler`` a ``synthesize`` call is the span ``tts.call``,
  holding ``tts.acoustic`` (the forward up to the mel on the host), inside
  it ``tts.length`` (the device-to-host read of the predicted length), and
  ``tts.vocode`` (the vocoder, whose ``vocoder.*`` / ``sampler.*`` spans sit
  inside). ``counters`` counts the calls, their tokens and their predicted
  frames.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from fastdiff_tpu_torch.config import AudioConfig, TrainConfig
from fastdiff_tpu_torch.data.dataset import (VocoderDataset,
                                             endless_index_stream)
from fastdiff_tpu_torch.diffusion.sampler import make_sampler
from fastdiff_tpu_torch.models.fastdiff import checked_device
from fastdiff_tpu_torch.models.fastspeech2 import (DEFAULT_LAMBDAS,
                                                   FastSpeech2, FS2Config,
                                                   fastspeech2_loss)
from fastdiff_tpu_torch.ops.cwt import f0_to_cwt
from fastdiff_tpu_torch.ops.mel_losses import parse_mel_losses
from fastdiff_tpu_torch.ops.pitch import norm_interp_f0
from fastdiff_tpu_torch.parallel import mesh as meshlib
from fastdiff_tpu_torch.serving.batch_vocoder import BatchedVocoder
from fastdiff_tpu_torch.training.optim import AdamW
from fastdiff_tpu_torch.training.task import TrainState
from fastdiff_tpu_torch.tts.acoustic_graphs import AcousticGraphs
from fastdiff_tpu_torch.utils import audio_io
from fastdiff_tpu_torch.utils.profiling import span
from fastdiff_tpu_torch.vocoders import get_vocoder_cls

def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def _np_mel_energy(mel: np.ndarray) -> np.ndarray:
    """Host mirror of ``models.fastspeech2.mel_energy`` (log10 front end)."""
    lin = np.power(10.0, mel)
    return np.log10(1.0 + np.sqrt((lin ** 2).sum(-1))).astype(np.float32)


def _is_sil_phone(p: str) -> bool:
    """Silence / punctuation phones are the tokens with no letter."""
    return not any(ch.isalpha() for ch in p)


def collate_tts(items, token_pad: int, frame_pad: int, n_mels: int,
                pitch_type: str = "frame",
                pitch_norm: str = "log") -> Dict:
    """Pad a list of TTS records to (token_pad, frame_pad).

    Emits tokens / mels / mel2ph / dur, coarse ``pitch``, normalized and
    interpolated ``f0`` with ``uv``, the per-frame ``energy`` of the mel,
    ``is_sil`` word-boundary marks, the cwt fields when ``pitch_type`` is
    ``cwt`` and ``spk_embed`` when every item has one. Without ``mel2ph``
    an item's phones get uniform spans."""
    batch = len(items)
    tokens = np.zeros((batch, token_pad), np.int32)
    mels = np.zeros((batch, frame_pad, n_mels), np.float32)
    mel2ph = np.zeros((batch, frame_pad), np.int32)
    pitch = np.ones((batch, frame_pad), np.int32)
    f0 = np.zeros((batch, frame_pad), np.float32)
    uv = np.zeros((batch, frame_pad), np.float32)
    energy = np.zeros((batch, frame_pad), np.float32)
    dur = np.zeros((batch, token_pad), np.float32)
    is_sil = np.zeros((batch, token_pad), np.float32)
    want_cwt = pitch_type == "cwt"
    cwt_spec = np.zeros((batch, frame_pad, 10), np.float32) if want_cwt else None
    cwt_mean = np.zeros((batch,), np.float32) if want_cwt else None
    cwt_std = np.ones((batch,), np.float32) if want_cwt else None
    for b, item in enumerate(items):
        tok = np.asarray(item["phone"], np.int32)
        mel = np.asarray(item["mel"], np.float32)
        t_ph, t_mel = len(tok), mel.shape[0]
        tokens[b, :t_ph] = tok
        mels[b, :t_mel] = mel
        energy[b, :t_mel] = _np_mel_energy(mel)
        if "ph" in item:
            for i, p in enumerate(str(item["ph"]).split()[:t_ph]):
                is_sil[b, i] = float(_is_sil_phone(p))
        if "mel2ph" in item:
            mel2ph[b, :t_mel] = np.asarray(item["mel2ph"], np.int32)
        else:
            bounds = np.linspace(0, t_mel, t_ph + 1).astype(np.int64)
            m2p = np.zeros(t_mel, np.int32)
            for p in range(t_ph):
                m2p[bounds[p]: bounds[p + 1]] = p + 1
            mel2ph[b, :t_mel] = m2p
        if "pitch" in item:
            pitch[b, :t_mel] = np.asarray(item["pitch"], np.int32)[:t_mel]
        if "f0" in item:
            f0_raw = np.asarray(item["f0"], np.float32)[:t_mel]
            f0n, uvb = norm_interp_f0(f0_raw, pitch_norm)
            f0[b, :len(f0n)] = f0n
            uv[b, :len(uvb)] = uvb
            uv[b, len(uvb):t_mel] = 1.0
            if want_cwt:
                if "cwt_spec" in item:
                    spec = np.asarray(item["cwt_spec"], np.float32)[:t_mel]
                    mean = float(item.get("cwt_mean", 0.0))
                    std = float(item.get("cwt_std", 1.0))
                else:
                    spec, mean, std = f0_to_cwt(f0_raw)
                    spec = spec[:t_mel]
                cwt_spec[b, :len(spec)] = spec
                cwt_mean[b] = mean
                cwt_std[b] = std
        dur[b] = np.bincount(mel2ph[b], minlength=token_pad + 1)[1: token_pad + 1]
    out = {"tokens": tokens, "mels": mels, "mel2ph": mel2ph,
           "pitch": pitch, "f0": f0, "uv": uv, "energy": energy,
           "dur": dur, "is_sil": is_sil}
    if want_cwt:
        out.update(cwt_spec=cwt_spec, cwt_mean=cwt_mean, cwt_std=cwt_std)
    if all("spk_embed" in item for item in items):
        out["spk_embed"] = np.stack(
            [np.asarray(item["spk_embed"], np.float32) for item in items])
    return out


class FastSpeech2Task:
    def __init__(self, hparams: dict, device="cuda"):
        self.hparams = hparams
        self.device = checked_device(device)
        self.mesh = meshlib.make_mesh(device=self.device)
        self.train_cfg = TrainConfig.from_hparams(hparams)
        self.audio_cfg = AudioConfig.from_hparams(hparams)
        vocab_size = int(hparams.get("vocab_size", 0)) or \
            self._vocab_size_from_phone_set(hparams)
        self.model_cfg = FS2Config.from_hparams(
            {**hparams, "vocab_size": vocab_size})
        self.mel_losses = parse_mel_losses(hparams.get("mel_loss", "l1"))
        self.lambdas = {k: float(hparams[k]) for k in DEFAULT_LAMBDAS
                        if k in hparams}
        self.pitch_loss = str(hparams.get("pitch_loss", "l1"))
        self.vocoder = None
        self.generator = None
        self.acoustic_graphs = None
        self.counters = {"calls": 0, "tokens": 0, "frames": 0}
        self._datasets: Dict[str, VocoderDataset] = {}

    @staticmethod
    def _vocab_size_from_phone_set(hparams: dict) -> int:
        fn = os.path.join(hparams.get("binary_data_dir", ""), "phone_set.json")
        if os.path.exists(fn):
            with open(fn) as f:
                return len(json.load(f)) + 3   # + reserved ids
        return 100

    # -- state -------------------------------------------------------------
    def build_state(self, seed: Optional[int] = None) -> TrainState:
        """The seed weights on the task's device, their optimizer, step 0."""
        seed = self.train_cfg.seed if seed is None else seed
        model = FastSpeech2(self.model_cfg, seed=seed).to(self.device)
        optimizer = AdamW(
            model.parameters(), self.train_cfg,
            warmup_updates=int(self.hparams.get("warmup_updates", 8000)),
            hidden_size=self.model_cfg.hidden)
        return TrainState(model, optimizer,
                          ddp=meshlib.data_parallel(model, self.mesh))

    # -- steps -------------------------------------------------------------
    def _to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(np.asarray(v), device=self.device)
                for k, v in batch.items()}

    def _apply_train(self, model: FastSpeech2, batch: dict) -> dict:
        """The teacher-mode forward: durations, pitch and energy given."""
        cfg = self.model_cfg
        kwargs = dict(mel2ph=batch["mel2ph"],
                      spk_embed=batch.get("spk_embed"))
        if cfg.use_pitch:
            if cfg.pitch_type == "coarse":
                kwargs["pitch"] = batch["pitch"]
            else:
                kwargs["f0"] = batch["f0"]
                kwargs["uv"] = batch["uv"]
        if cfg.use_energy:
            kwargs["energy"] = batch["energy"]
        return model(batch["tokens"], **kwargs)

    def loss(self, model: FastSpeech2, batch: dict) -> dict:
        """The loss dict of a batch of device tensors; ``loss`` is
        ``total``."""
        out = self._apply_train(model, batch)
        losses = fastspeech2_loss(
            out, batch, self.model_cfg, mel_loss_and_lambda=self.mel_losses,
            lambdas=self.lambdas, pitch_loss=self.pitch_loss)
        losses["loss"] = losses["total"]
        return losses

    def _floats(self, losses: dict) -> dict:
        values = meshlib.mean_over_ranks(
            torch.stack([v.detach() for v in losses.values()]), self.mesh)
        return dict(zip(losses, values.tolist()))

    def train_step(self, state: TrainState, batch: dict,
                   generator: Optional[torch.Generator] = None) -> dict:
        """One update in place; returns the loss terms as floats."""
        params = list(state.model.parameters())
        losses = self.loss(state.net, self._to_device(
            meshlib.shard_batch(batch, self.mesh)))
        grads = meshlib.gradients(losses["total"], params, state.ddp)
        state.optimizer.step(grads)
        state.step += 1
        return self._floats(losses)

    @torch.no_grad()
    def val_step(self, state: TrainState, batch: dict,
                 generator: Optional[torch.Generator] = None) -> dict:
        return self._floats(self.loss(state.model, self._to_device(batch)))

    @torch.no_grad()
    def val_figures(self, state: TrainState, batch: dict) -> Dict:
        """GT-vs-predicted mel figures of a validation batch, up to
        ``min(num_valid_plots, B, 2)`` (tts_base.py:224-245 plot_mel)."""
        from fastdiff_tpu_torch.utils.plot import spec_to_figure
        out = self._apply_train(state.model, self._to_device(batch))
        pred_mels = out["mel"].cpu().numpy()
        mels = np.asarray(batch["mels"])
        figs = {}
        n_plots = min(int(self.hparams.get("num_valid_plots", 2)),
                      mels.shape[0], 2)
        for b in range(n_plots):
            t_valid = int((np.asarray(batch["mel2ph"][b]) > 0).sum()) \
                or mels.shape[1]
            stacked = np.concatenate(
                [mels[b, :t_valid], pred_mels[b, :t_valid]], axis=1)
            figs[f"mel_val_{b}"] = spec_to_figure(
                stacked, title=f"val {b}: GT (left) vs pred (right)")
        return figs

    # -- data --------------------------------------------------------------
    def _loader(self, prefix: str, batch_size: int, endless: bool
                ) -> Iterator[Dict]:
        if prefix not in self._datasets:   # kept across validations
            self._datasets[prefix] = VocoderDataset(self.hparams, prefix)
        ds = self._datasets[prefix]
        stream = endless_index_stream(len(ds), self.train_cfg.seed, True) \
            if endless else iter(range(len(ds)))
        buf = []
        for idx in stream:
            item = ds[idx]
            if "phone" not in item:
                continue
            buf.append(item)
            if len(buf) == batch_size:
                token_pad = _round_up(max(len(i["phone"]) for i in buf), 8)
                frame_pad = _round_up(max(i["mel"].shape[0] for i in buf), 32)
                yield collate_tts(buf, token_pad, frame_pad,
                                  self.audio_cfg.num_mels,
                                  pitch_type=self.model_cfg.pitch_type,
                                  pitch_norm=self.model_cfg.pitch_norm)
                buf = []

    def train_dataloader(self):
        return self._loader("train", self.train_cfg.max_sentences, True)

    def val_dataloader(self):
        return self._loader("valid", max(1, self.train_cfg.max_valid_sentences),
                            False)

    # -- inference ---------------------------------------------------------
    @torch.no_grad()
    def infer_mel(self, state: TrainState, tokens) -> np.ndarray:
        """tokens (T_ph,) -> mel (T_valid, n_mels) from the forward with
        predicted durations at ``t_mel = max_frames``."""
        return self._acoustic(state, tokens)[0]

    def _acoustic(self, state: TrainState, tokens) -> tuple:
        """(``infer_mel``'s mel, the forward's output dict on the device):
        ``state.model`` through ``AcousticGraphs``, one graph a token
        count."""
        with span("tts.acoustic"):
            if self.acoustic_graphs is None or \
                    self.acoustic_graphs.model is not state.model:
                self.acoustic_graphs = AcousticGraphs(state.model)
            tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                                     device=self.device)[None]
            out = self.acoustic_graphs(tokens)
            with span("tts.length"):
                t_valid = int(out["mel_mask"][0].sum())
            return out["mel"][0, :t_valid].cpu().numpy(), out

    def tts_vocoder(self):
        """The vocoder ``synthesize`` runs, built on the first call and kept,
        and its generator (``self.generator``): the registry's; with
        ``infer_frame_bucket`` set, its denoiser behind a ``BatchedVocoder``
        at that bucket with one graph for every bucket up to ``max_frames``
        and the registry vocoder's generator."""
        if self.vocoder is None:
            vocoder = get_vocoder_cls(self.hparams)(self.hparams,
                                                    device=self.device)
            self.generator = getattr(vocoder, "generator", None)
            bucket = int(self.hparams.get("infer_frame_bucket", 0) or 0)
            if bucket:
                graphs = -(-self.model_cfg.max_len // bucket)
                vocoder = BatchedVocoder.from_sampler(
                    make_sampler(vocoder.model, vocoder.constants,
                                 max_graphs=graphs),
                    hop_size=vocoder.hop, frame_bucket=bucket, max_batch=1,
                    devices=[self.device])
            self.vocoder = vocoder
        return self.vocoder

    @torch.no_grad()
    def synthesize(self, state: TrainState, tokens, vocoder=None,
                   generator: Optional[torch.Generator] = None):
        """The text-to-wav entry: tokens (T_ph,) -> (waveform (T_valid *
        hop,) float32, the forward's output dict on the device). The
        vocoder is ``tts_vocoder()`` unless the caller gives one with a
        ``spec2wav``; a ``BatchedVocoder`` draws from ``generator``
        (default the task's)."""
        if vocoder is None:
            vocoder = self.tts_vocoder()
        with span("tts.call"):
            mel, out = self._acoustic(state, tokens)
            self.counters["calls"] += 1
            self.counters["tokens"] += len(tokens)
            self.counters["frames"] += mel.shape[0]
            with span("tts.vocode"):
                if isinstance(vocoder, BatchedVocoder):
                    if generator is None:
                        generator = self.generator
                    wav, = vocoder.vocode([mel], generator=generator)
                else:
                    wav = vocoder.spec2wav(mel)
        return wav, out

    def infer_to_wav(self, state: TrainState, tokens, out_path: str,
                     vocoder=None) -> np.ndarray:
        """tokens (T_ph,) -> mel -> waveform through ``synthesize``
        (tts_base.py after_infer role); writes the peak-normalized wav to
        ``out_path`` when one is given."""
        wav, _ = self.synthesize(state, tokens, vocoder)
        if out_path:
            audio_io.save_wav(wav / max(1e-9, np.abs(wav).max()), out_path,
                              self.audio_cfg.sample_rate)
        return wav
