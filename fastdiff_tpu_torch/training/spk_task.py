"""Speaker-encoder verification training (``fastdiff_tpu/training/spk_task.py``).

Trains the d-vector network (``models/spk_encoder.py``) without an external
dataset:

- pseudo-speakers are made from any mel corpus by deterministic
  per-speaker spectral warps (frequency-axis warp, spectral tilt, gain);
  crops of one warped voice are positives (``speaker_warp``,
  ``make_crops``: numpy, copied from JAX, so one ``np.random.default_rng``
  gives the same crops);
- the loss is the GE2E-style softmax over scaled cosine similarities to
  the speakers' centroids, the utterance's own centroid excluding it
  (``proto_loss``; Wan et al. 2018);
- quality is the verification EER over same / different-speaker crop
  pairs (``verification_eer``, ``eer``: numpy).

``train_spk_encoder`` runs ``torch.optim.Adam(lr)``, whose eps (1e-8) and
bias correction are ``optax.adam``'s. The trained weights save through
``training/checkpoint.py`` (``{"params": model.state_dict()}``) and load
through ``spk_embed_ckpt`` (``models/spk_encoder.py``).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fastdiff_tpu_torch.models.spk_encoder import SpeakerEncoder


# ---------------------------------------------------------------------------
# Pseudo-speaker augmentation
# ---------------------------------------------------------------------------

def speaker_warp(mel: np.ndarray, spk_seed: int,
                 holdout: bool = False) -> np.ndarray:
    """Deterministic per-speaker voice transform of a log-mel (T, M):
    frequency-axis warp, spectral tilt and gain. ``holdout=True`` draws
    every parameter from ranges disjoint from the training ones (warp
    outside (0.82, 1.22), |tilt| > 0.3, |gain| > 0.2) and a disjoint seed
    space."""
    rng = np.random.default_rng((500_000 if holdout else 1000) + spk_seed)
    if holdout:
        alpha = (rng.uniform(0.74, 0.81) if rng.uniform() < 0.5
                 else rng.uniform(1.23, 1.30))
        tilt = float(rng.choice([-1, 1])) * rng.uniform(0.31, 0.42)
        gain = float(rng.choice([-1, 1])) * rng.uniform(0.21, 0.30)
    else:
        alpha = rng.uniform(0.82, 1.22)      # freq warp factor
        tilt = rng.uniform(-0.3, 0.3)        # dB/bin-style tilt
        gain = rng.uniform(-0.2, 0.2)
    t, m = mel.shape
    src = np.clip(np.arange(m) * alpha, 0, m - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, m - 1)
    frac = (src - lo).astype(np.float32)
    warped = mel[:, lo] * (1 - frac) + mel[:, hi] * frac
    tilt_vec = tilt * (np.arange(m, dtype=np.float32) / m - 0.5)
    return (warped + tilt_vec[None, :] + gain).astype(np.float32)


def make_crops(mels: List[np.ndarray], n_spk: int, n_utt: int,
               crop: int, rng: np.random.Generator,
               holdout: bool = False) -> np.ndarray:
    """(n_spk, n_utt, crop, M) batch of warped random crops."""
    m = mels[0].shape[1]
    out = np.zeros((n_spk, n_utt, crop, m), np.float32)
    for s in range(n_spk):
        spk_seed = int(rng.integers(0, 10_000))
        for u in range(n_utt):
            mel = mels[int(rng.integers(len(mels)))]
            if mel.shape[0] <= crop:
                mel = np.pad(mel, ((0, crop - mel.shape[0] + 1), (0, 0)),
                             mode="wrap")
            start = int(rng.integers(0, mel.shape[0] - crop))
            out[s, u] = speaker_warp(mel[start: start + crop], spk_seed,
                                     holdout=holdout)
    return out


# ---------------------------------------------------------------------------
# GE2E-style prototypical loss
# ---------------------------------------------------------------------------

def proto_loss(model: SpeakerEncoder, batch: torch.Tensor,
               scale: float = 10.0) -> torch.Tensor:
    """batch (S, U, T, M) -> scalar: each utterance scored against every
    speaker's centroid (its own excluding itself) by scaled cosine
    similarity and softmax cross-entropy."""
    s, u, t, m = batch.shape
    emb = model(batch.reshape(s * u, t, m)).reshape(s, u, -1)   # unit-norm
    centroids = emb.mean(dim=1)                                 # (S, D)
    own = (centroids[:, None, :] * u - emb) / (u - 1)           # (S, U, D)
    own = own / torch.linalg.norm(own, dim=-1, keepdim=True)
    sim = torch.einsum("sud,kd->suk", emb, centroids / torch.linalg.norm(
        centroids, dim=-1, keepdim=True))
    own_sim = torch.einsum("sud,sud->su", emb, own)
    eye = torch.eye(s, device=emb.device)[:, None, :]           # (S, 1, S)
    sim = sim * (1 - eye) + own_sim[..., None] * eye
    logp = F.log_softmax(scale * sim, dim=-1)                   # (S, U, S)
    labels = torch.arange(s, device=emb.device)[:, None, None].expand(s, u, 1)
    return -torch.gather(logp, -1, labels).mean()


def train_spk_encoder(mels: List[np.ndarray], steps: int = 300,
                      n_spk: int = 8, n_utt: int = 4, crop: int = 80,
                      lr: float = 1e-3, seed: int = 0,
                      device="cuda") -> Tuple[SpeakerEncoder, list]:
    """Train on pseudo-speaker crops from seed-``seed`` weights; returns
    (model, loss history)."""
    rng = np.random.default_rng(seed)
    model = SpeakerEncoder(seed=seed, n_mels=mels[0].shape[1], device=device)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    history = []
    for _ in range(steps):
        batch = torch.from_numpy(make_crops(mels, n_spk, n_utt, crop, rng))
        loss = proto_loss(model, batch.to(model.device))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        history.append(float(loss.detach()))
    return model, history


# ---------------------------------------------------------------------------
# Verification EER
# ---------------------------------------------------------------------------

@torch.no_grad()
def verification_eer(model: SpeakerEncoder, mels: List[np.ndarray],
                     n_spk: int = 16, n_utt: int = 6, crop: int = 80,
                     seed: int = 123, holdout: bool = False) -> float:
    """Equal error rate over all same / different-speaker crop pairs;
    ``holdout`` scores voices from the disjoint transform ranges."""
    rng = np.random.default_rng(seed)
    batch = make_crops(mels, n_spk, n_utt, crop, rng, holdout=holdout)
    s, u, t, m = batch.shape
    emb = model(torch.from_numpy(batch.reshape(s * u, t, m)).to(
        model.device)).cpu().numpy().reshape(s, u, -1)
    same, diff = [], []
    for a in range(s):
        for i in range(u):
            for j in range(i + 1, u):
                same.append(float(emb[a, i] @ emb[a, j]))
        for b in range(a + 1, s):
            for i in range(u):
                for j in range(u):
                    diff.append(float(emb[a, i] @ emb[b, j]))
    return eer(np.asarray(same), np.asarray(diff))


def eer(same_scores: np.ndarray, diff_scores: np.ndarray) -> float:
    """EER: the rate at the threshold where false accept == false reject."""
    thresholds = np.unique(np.concatenate([same_scores, diff_scores]))
    frrs = np.array([(same_scores < th).mean() for th in thresholds])
    fars = np.array([(diff_scores >= th).mean() for th in thresholds])
    idx = int(np.argmin(np.abs(frrs - fars)))
    return float((frrs[idx] + fars[idx]) / 2)
