"""Optimizer of the training recipe, with optax's semantics written out
(``fastdiff_tpu/training/optim.py``).

The JAX package chains ``optax.clip_by_global_norm(clip)`` and
``optax.adamw(lr, b1, b2, weight_decay=wd)`` (eps 1e-8), wrapped in
``optax.MultiSteps`` when ``accumulate_grad_batches`` > 1. Per update:

    g     <- g                      if ||g|| < clip
             (g / ||g||) * clip     otherwise (no epsilon, unlike
                                    torch.nn.utils.clip_grad_norm_)
    mu    <- (1 - b1) * g   + b1 * mu
    nu    <- (1 - b2) * g^2 + b2 * nu
    u     <- (mu / (1 - b1^n)) / (sqrt(nu / (1 - b2^n)) + eps) + wd * p
    p     <- p + (-lr(n - 1)) * u

with n the update count after the increment and ``lr`` constant or the
rsqrt warm-up schedule of the count before it. Under accumulation each
mini-step folds its gradient into a running mean (acc += (g - acc) /
(k + 1)) and every ``accumulate_grad_batches``-th one applies the update
above to the mean and resets it. Sums and products run in float32 in the
same order as optax, so the two agree to float32 rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from fastdiff_tpu_torch.config import TrainConfig


def learning_rate(cfg: TrainConfig, count: int, warmup_updates: int = 8000,
                  hidden_size: int = 256) -> float:
    """The learning rate of update ``count`` (0-based): ``cfg.lr``, or the
    rsqrt schedule max(lr * min(s / warmup, 1) * max(warmup, s)^-0.5 *
    hidden^-0.5, 1e-7) with s = max(count, 1), in float32."""
    if cfg.scheduler != "rsqrt":
        return float(np.float32(cfg.lr))
    f32 = np.float32
    s = max(count, 1)
    warm = min(f32(s) / f32(warmup_updates), f32(1.0))
    decay = f32(max(warmup_updates, s)) ** f32(-0.5)
    lr = f32(cfg.lr) * warm * decay * f32(hidden_size ** -0.5)
    return float(max(lr, f32(1e-7)))


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, float32."""
    return torch.stack([t.float().square().sum() for t in tensors]).sum().sqrt()


class AdamW:
    """optax ``clip_by_global_norm`` + ``adamw`` (+ ``MultiSteps``) over a
    list of parameters, updated in place. ``step(grads)`` takes one
    gradient per parameter."""

    def __init__(self, params, cfg: TrainConfig, warmup_updates: int = 8000,
                 hidden_size: int = 256):
        self.params = list(params)
        self.cfg = cfg
        self.warmup_updates = warmup_updates
        self.hidden_size = hidden_size
        self.every = max(1, cfg.accumulate_grad_batches)
        self.count = 0              # updates applied
        self.mini_step = 0          # gradients folded into acc
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if self.every > 1 else [])

    @torch.no_grad()
    def step(self, grads) -> None:
        grads = list(grads)
        if self.every > 1:
            n = self.mini_step
            self.acc = [a + (g - a) / (n + 1)
                        for a, g in zip(self.acc, grads)]
            if n < self.every - 1:
                self.mini_step += 1
                return
            grads = self.acc
            self.acc = [torch.zeros_like(a) for a in grads]
            self.mini_step = 0
        self._update(grads)

    def _update(self, grads) -> None:
        cfg = self.cfg
        if cfg.clip_grad_norm > 0:
            norm = global_norm(grads)
            keep = norm < cfg.clip_grad_norm
            grads = [torch.where(keep, g, g / norm * cfg.clip_grad_norm)
                     for g in grads]
        lr = learning_rate(cfg, self.count, self.warmup_updates,
                           self.hidden_size)
        self.count += 1
        b1, b2 = cfg.adam_beta1, cfg.adam_beta2
        f32 = np.float32
        bc1 = float(f32(1) - f32(b1) ** f32(self.count))
        bc2 = float(f32(1) - f32(b2) ** f32(self.count))
        self.mu = torch._foreach_add(torch._foreach_mul(grads, 1 - b1),
                                     torch._foreach_mul(self.mu, b1))
        sq = torch._foreach_mul(grads, grads)
        self.nu = torch._foreach_add(torch._foreach_mul(sq, 1 - b2),
                                     torch._foreach_mul(self.nu, b2))
        den = torch._foreach_add(
            torch._foreach_sqrt(torch._foreach_div(self.nu, bc2)), 1e-8)
        upd = torch._foreach_div(torch._foreach_div(self.mu, bc1), den)
        upd = torch._foreach_add(upd, torch._foreach_mul(
            self.params, cfg.weight_decay))
        torch._foreach_add_(self.params, torch._foreach_mul(upd, -lr))

    def state_dict(self) -> dict:
        return {"count": self.count, "mini_step": self.mini_step,
                "mu": self.mu, "nu": self.nu, "acc": self.acc}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        for mine, theirs in (("mu", state["mu"]), ("nu", state["nu"]),
                             ("acc", state["acc"])):
            setattr(self, mine, [t.to(p.device, p.dtype) for t, p in
                                 zip(theirs, self.params)])
