"""Transformer building blocks of the TTS (text -> mel) models
(``fastdiff_tpu/models/transformer.py``), as ``nn.Module``s.

Activations are (B, T, H), as in JAX; masks are (B, T) float {0, 1}. A
layer is pre-LN self-attention + residual, then pre-LN conv FFN (k=9 conv
-> ReLU -> k=9 conv, 'same' padding) + residual, with padding zeroed after
each block.

Attention is written out (matmul, ``masked_fill`` of padded keys with
-1e9, softmax, matmul) rather than ``scaled_dot_product_attention``: JAX
fills with -1e9, not -inf, so a query whose keys are all padding gets
uniform weights where a boolean-masked SDPA gives NaN or zeros.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-5


def sinusoidal_positions(length: int, dim: int) -> np.ndarray:
    """Fairseq-style sinusoidal table, sin block then cos block, built in
    float64 and cast to float32 (``transformer.py:sinusoidal_positions``;
    note the ``half - 1`` denominator)."""
    half = dim // 2
    freq = np.exp(np.arange(half) * -(np.log(10000.0) / (half - 1)))
    args = np.arange(length)[:, None] * freq[None, :]
    emb = np.concatenate([np.sin(args), np.cos(args)], axis=1)
    if dim % 2:
        emb = np.concatenate([emb, np.zeros((length, 1))], axis=1)
    return emb.astype(np.float32)


class SelfAttention(nn.Module):
    """One fused qkv projection, scale 1/sqrt(dh), padded keys -> -1e9."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        dh = d // self.heads
        q, k, v = (z.reshape(b, t, self.heads, dh).transpose(1, 2)
                   for z in self.qkv(x).split(d, dim=-1))
        logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh)
        logits = logits.masked_fill(mask[:, None, None, :] <= 0, -1e9)
        weights = torch.softmax(logits, dim=-1)
        out = torch.matmul(weights, v).transpose(1, 2).reshape(b, t, d)
        return self.out(out)


class ConvFFN(nn.Module):
    def __init__(self, dim: int, hidden: int, kernel_size: int = 9):
        super().__init__()
        pad = (kernel_size - 1) // 2
        self.conv1 = nn.Conv1d(dim, hidden, kernel_size, padding=pad)
        self.conv2 = nn.Conv1d(hidden, dim, kernel_size, padding=pad)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.conv1(x.transpose(1, 2)))
        return self.conv2(h).transpose(1, 2)


class EncoderLayer(nn.Module):
    """Pre-LN self-attention + conv FFN with residuals, padding zeroed
    after each (``transformer.py:encoder_layer``)."""

    def __init__(self, dim: int, heads: int, ffn_hidden: int,
                 ffn_kernel: int = 9):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = SelfAttention(dim, heads)
        self.ln2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ffn = ConvFFN(dim, ffn_hidden, ffn_kernel)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        m = mask[..., None]
        x = (x + self.attn(self.ln1(x), mask)) * m
        return (x + self.ffn(self.ln2(x))) * m


class TransformerStack(nn.ModuleList):
    def __init__(self, layers: int, dim: int, heads: int, ffn_hidden: int,
                 ffn_kernel: int = 9):
        super().__init__(EncoderLayer(dim, heads, ffn_hidden, ffn_kernel)
                         for _ in range(layers))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        for layer in self:
            x = layer(x, mask)
        return x
