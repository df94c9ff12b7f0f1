"""DiffWave's denoiser (Kong et al., ICLR 2021, arXiv:2009.09761) in plain
PyTorch, float32: the ``denoiser: wavenet`` family.

    eps(x_t, mel, t):
      emb = swish(dense(swish(dense(sinusoid(t)))))
      x = relu(conv1x1(audio, 1 -> C))
      cond_n = two (ConvTranspose2d (3, 2s), stride (1, s), pad (1, s/2)
               + leaky ReLU 0.4) upsamplings of the mel, per layer n,
               cropped to the audio's length (s = 16 fullband)
      per layer n of N: h = conv3_{dil 2^(n mod cycle)}(x + dense_n(emb))
                           + conv1x1(cond_n, M -> 2C)
                        out = tanh(h_a) * sigmoid(h_b)
                        x = (x + conv1x1(out)) * sqrt(1/2)
                        skip += conv1x1(out)
      eps = conv1x1(relu(conv1x1(skip * sqrt(1/N))))

Every convolution carries weight norm as ``v``, ``g`` and ``bias`` (a
vector ``g`` per output channel; a scalar ``g`` over the whole kernel for
the upsamplers); the dense layers and the output conv have plain weights.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.common import (conv1d, identity, leaky, linear,
                                        step_embedding, swish, weight_norm)


def _sizes(cfg: dict) -> tuple:
    c = int(cfg["res_channels"])
    skip = int(cfg["skip_channels"])
    stride = 8 if cfg["multiband"] else 16
    return (c, skip, int(cfg["num_res_layers"]), int(cfg["dilation_cycle"]),
            int(cfg["cond_channels"]), stride)


def param_shapes(cfg: dict) -> dict:
    """{parameter name: shape} of the denoiser."""
    c, skip, layers, _, cond, s = _sizes(cfg)
    e_in, e_mid, e_out = (int(cfg[f"diffusion_step_embed_dim_{x}"])
                          for x in ("in", "mid", "out"))
    shapes = {}

    def wn_conv(name, cout, cin, k):
        shapes.update({f"{name}.v": (cout, cin, k), f"{name}.g": (cout,),
                       f"{name}.bias": (cout,)})

    def dense(name, cout, cin):
        shapes.update({f"{name}.weight": (cout, cin), f"{name}.bias": (cout,)})

    wn_conv("init_conv", c, 1, 1)
    dense("fc_t1", e_mid, e_in)
    dense("fc_t2", e_out, e_mid)
    wn_conv("final_conv", skip, skip, 1)
    shapes.update({"out_conv.weight": (1, skip, 1), "out_conv.bias": (1,)})
    for n in range(layers):
        blk = f"blocks.{n}"
        dense(f"{blk}.fc_t", c, e_out)
        wn_conv(f"{blk}.dilated_conv", 2 * c, c, 3)
        for u in range(2):
            shapes.update({f"{blk}.upsamplers.{u}.v": (1, 1, 3, 2 * s),
                           f"{blk}.upsamplers.{u}.g": (),
                           f"{blk}.upsamplers.{u}.bias": (1,)})
        wn_conv(f"{blk}.mel_conv", 2 * c, cond, 1)
        wn_conv(f"{blk}.res_conv", c, c, 1)
        wn_conv(f"{blk}.skip_conv", skip, c, 1)
    return shapes


def _wn(w, name, x, quant, dilation=1):
    return conv1d(x, weight_norm(w[f"{name}.v"], w[f"{name}.g"]),
                  w[f"{name}.bias"], quant, dilation)


def forward(w: dict, cfg: dict, audio: torch.Tensor, mel: torch.Tensor,
            t: torch.Tensor, quant=identity) -> torch.Tensor:
    """audio (B, L), mel (B, F, n_mels), t (B,) -> eps (B, L), float32."""
    c, _, layers, cycle, _, s = _sizes(cfg)
    length = audio.shape[1]
    emb = step_embedding(t, int(cfg["diffusion_step_embed_dim_in"]))
    emb = swish(linear(emb, w["fc_t1.weight"], w["fc_t1.bias"], quant))
    emb = swish(linear(emb, w["fc_t2.weight"], w["fc_t2.bias"], quant))
    x = torch.relu(_wn(w, "init_conv", audio[:, None].float(), quant))
    mel2d = mel.float().transpose(1, 2)[:, None]             # (B, 1, M, F)
    skip = 0.0
    for n in range(layers):
        blk = f"blocks.{n}"
        h = x + linear(emb, w[f"{blk}.fc_t.weight"], w[f"{blk}.fc_t.bias"],
                       quant)[:, :, None]
        h = _wn(w, f"{blk}.dilated_conv", h, quant, 2 ** (n % cycle))
        cond = mel2d
        for u in range(2):
            up = f"{blk}.upsamplers.{u}"
            kernel = weight_norm(w[f"{up}.v"], w[f"{up}.g"])
            cond = quant(F.conv_transpose2d(quant(cond), quant(kernel),
                                            w[f"{up}.bias"], stride=(1, s),
                                            padding=(1, s // 2)))
            cond = leaky(cond, 0.4)
        h = h + _wn(w, f"{blk}.mel_conv", cond[:, 0, :, :length], quant)
        out = torch.tanh(h[:, :c]) * torch.sigmoid(h[:, c:])
        x = (x + _wn(w, f"{blk}.res_conv", out, quant)) * math.sqrt(0.5)
        skip = skip + _wn(w, f"{blk}.skip_conv", out, quant)
    skip = torch.relu(_wn(w, "final_conv", skip * math.sqrt(1.0 / layers),
                          quant))
    return conv1d(skip, w["out_conv.weight"], w["out_conv.bias"],
                  quant)[:, 0]
