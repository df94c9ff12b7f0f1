"""FastDiff's denoiser (Huang et al., IJCAI 2022; the reference's
``modules/FastDiff/module/FastDiff_model.py``) in plain PyTorch, float32.

    eps(x_t, mel, t):
      step embedding (sinusoid, then two swish dense layers)
      x = conv7(audio, 1 -> C)
      three DBlocks (nearest downsample by 4, 8, 8; a 1x1 residual and
        three k3 convs with dilations 1, 2, 4 after leaky ReLU 0.2), each
        input kept as a skip
      three time-aware LVC blocks (hops 8, 64, 256), each:
        kernel predictor on mel + dense(step embedding): conv5, six conv3
          (leaky ReLU 0.1, residual over the six), then per-frame LVC
          kernels (layers, K, C, 2C) and biases (layers, 2C) by conv3
        x = transposed conv (stride r, kernel 2r) of leaky ReLU 0.2 of x
        per layer i: x += skip; y = lrelu(conv3_{dil 3^i}(lrelu(x)));
          z = LVC(y) with the frame's kernel; x += sigmoid(z_a) * tanh(z_b)
      conv7(x, C -> 1)

The weights are the inference model's, weight norm already folded in:
``Conv1d`` weights (O, I, K), ``ConvTranspose1d`` weights (I, O, K),
``Linear`` weights (O, I).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.common import (conv1d, identity, leaky, linear,
                                        step_embedding, swish)

N_PREDICTOR_CONVS = 6


def _sizes(cfg: dict) -> tuple:
    return (int(cfg["inner_channels"]), int(cfg["cond_channels"]),
            int(cfg["kpnet_hidden_channels"]), int(cfg["kpnet_conv_size"]),
            int(cfg["lvc_layers_each_block"]), int(cfg["lvc_kernel_size"]),
            [int(r) for r in cfg["upsample_ratios"]])


def param_shapes(cfg: dict) -> dict:
    """{parameter name: shape} of the inference model."""
    c, cond, hid, ksz, layers, k, ratios = _sizes(cfg)
    e_in, e_mid, e_out = (int(cfg[f"diffusion_step_embed_dim_{s}"])
                          for s in ("in", "mid", "out"))
    shapes = {}

    def conv(name, cout, cin, kernel):
        shapes[f"{name}.weight"] = (cout, cin, kernel)
        shapes[f"{name}.bias"] = (cout,)

    def dense(name, cout, cin):
        shapes[f"{name}.weight"] = (cout, cin)
        shapes[f"{name}.bias"] = (cout,)

    conv("first_audio_conv", c, 1, 7)
    conv("final_conv", 1, c, 7)
    dense("fc_t1", e_mid, e_in)
    dense("fc_t2", e_out, e_mid)
    for n, r in enumerate(ratios):
        block = f"lvc_blocks.{n}"
        shapes[f"{block}.upsample.weight"] = (c, c, 2 * r)
        shapes[f"{block}.upsample.bias"] = (c,)
        dense(f"{block}.fc_t", cond, e_out)
        kp = f"{block}.kernel_predictor"
        conv(f"{kp}.input_conv", hid, cond, 5)
        for j in range(N_PREDICTOR_CONVS):
            conv(f"{kp}.residual_convs.{j}", hid, hid, ksz)
        conv(f"{kp}.kernel_conv", layers * k * c * 2 * c, hid, ksz)
        conv(f"{kp}.bias_conv", layers * 2 * c, hid, ksz)
        for i in range(layers):
            conv(f"{block}.convs.{i}", c, c, k)
    for n in range(len(ratios)):
        conv(f"downsample.{n}.residual_dense", c, c, 1)
        for j in range(3):
            conv(f"downsample.{n}.convs.{j}", c, c, 3)
    return shapes


def lvc(y, kernels, biases, hop: int, quant=identity):
    """Location-variable convolution: y (B, C, F * hop), kernels
    (B, K, C, O, F), biases (B, O, F) -> (B, O, F * hop); frame f's
    samples are convolved with frame f's kernel over y padded by
    (K - 1) // 2 zeros at both ends of the whole signal."""
    b, c, length = y.shape
    k, frames = kernels.shape[1], kernels.shape[-1]
    pad = (k - 1) // 2
    yp = F.pad(quant(y), (pad, pad))
    windows = yp.unfold(2, hop + k - 1, hop)             # (B, C, F, hop+K-1)
    taps = torch.stack([windows[..., j:j + hop] for j in range(k)], dim=1)
    out = torch.einsum("bkcft,bkcof->boft", taps, quant(kernels))
    return quant((out + biases[..., None]).reshape(b, -1, frames * hop))


def _dblock(w, name, x, factor, quant):
    x = x[..., ::factor]
    residual = conv1d(x, w[f"{name}.residual_dense.weight"],
                      w[f"{name}.residual_dense.bias"], quant)
    for j in range(3):
        x = conv1d(leaky(x, 0.2), w[f"{name}.convs.{j}.weight"],
                   w[f"{name}.convs.{j}.bias"], quant, dilation=2 ** j)
    return x + residual


def _lvc_block(w, cfg, n, x, skip, mel, emb, quant):
    c, _, _, _, layers, k, ratios = _sizes(cfg)
    r = ratios[n]
    hop = 1
    for ratio in ratios[:n + 1]:
        hop *= ratio
    name = f"lvc_blocks.{n}"
    kp = f"{name}.kernel_predictor"
    b, _, frames = mel.shape

    cond = mel + linear(emb, w[f"{name}.fc_t.weight"], w[f"{name}.fc_t.bias"],
                        quant)[:, :, None]
    h = leaky(conv1d(cond, w[f"{kp}.input_conv.weight"],
                     w[f"{kp}.input_conv.bias"], quant), 0.1)
    res = h
    for j in range(N_PREDICTOR_CONVS):
        res = leaky(conv1d(res, w[f"{kp}.residual_convs.{j}.weight"],
                           w[f"{kp}.residual_convs.{j}.bias"], quant), 0.1)
    h = h + res
    kernels = conv1d(h, w[f"{kp}.kernel_conv.weight"],
                     w[f"{kp}.kernel_conv.bias"], quant).reshape(
                         b, layers, k, c, 2 * c, frames)
    biases = conv1d(h, w[f"{kp}.bias_conv.weight"],
                    w[f"{kp}.bias_conv.bias"], quant).reshape(
                        b, layers, 2 * c, frames)

    x = quant(F.conv_transpose1d(quant(leaky(x, 0.2)),
                                 quant(w[f"{name}.upsample.weight"]),
                                 w[f"{name}.upsample.bias"], stride=r,
                                 padding=r // 2 + r % 2, output_padding=r % 2))
    for i in range(layers):
        x = x + skip
        y = leaky(conv1d(leaky(x, 0.2), w[f"{name}.convs.{i}.weight"],
                         w[f"{name}.convs.{i}.bias"], quant,
                         dilation=3 ** i), 0.2)
        z = lvc(y, kernels[:, i], biases[:, i], hop, quant)
        x = x + torch.sigmoid(z[:, :c]) * torch.tanh(z[:, c:])
    return x


def forward(w: dict, cfg: dict, audio: torch.Tensor, mel: torch.Tensor,
            t: torch.Tensor, quant=identity) -> torch.Tensor:
    """audio (B, L), mel (B, F, n_mels), t (B,) -> eps (B, L), float32,
    L == F * prod(upsample_ratios)."""
    ratios = [int(r) for r in cfg["upsample_ratios"]]
    emb = step_embedding(t, int(cfg["diffusion_step_embed_dim_in"]))
    emb = swish(linear(emb, w["fc_t1.weight"], w["fc_t1.bias"], quant))
    emb = swish(linear(emb, w["fc_t2.weight"], w["fc_t2.bias"], quant))
    x = conv1d(audio[:, None].float(), w["first_audio_conv.weight"],
               w["first_audio_conv.bias"], quant)
    skips = []
    for n, factor in enumerate(ratios[::-1]):
        skips.append(x)
        x = _dblock(w, f"downsample.{n}", x, factor, quant)
    mel = mel.float().transpose(1, 2)
    for n, skip in enumerate(skips[::-1]):
        x = _lvc_block(w, cfg, n, x, skip, mel, emb, quant)
    return conv1d(x, w["final_conv.weight"], w["final_conv.bias"],
                  quant)[:, 0]
