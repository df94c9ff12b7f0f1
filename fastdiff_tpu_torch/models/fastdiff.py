"""FastDiff denoiser: NCL and NWC forwards for inference, NCL for training
(``fastdiff_tpu/models/fastdiff.py``).

    input conv (k=7, 1->C)
      -> 3 DBlocks (nearest downsample x4, x8, x8), skips saved
      -> 3 time-aware LVC blocks (transposed-conv upsample x8, x8, x4; hops
         8, 64, 256), each conditioned on mel + a projection of the
         diffusion-step embedding through a kernel predictor
      -> output conv (k=7, C->1), run as the last LVC block's epilogue

Four inference routes, picked by ``infer_route`` (``resolve_infer_route``
reads it from ``use_pallas_block``), with the same parameters and the same
``state_dict``, so one converted JAX tree loads into any of them:

- ``"ncl"``: the JAX ``use_pallas_block="ncl"`` route
  (``_fastdiff_apply_ncl``), (B, C, L) activations; every LVC block runs
  Kernel A (K3) and Kernel B (K1), the last with the final conv as K2's
  epilogue. The first conv and the DBlocks run as K8 with the NCL layout
  and this route's cast points (``downpath_ncl``) where the input allows
  it: bf16, C = 32, factors (4, 8, 8) and a ``downpath_fusable`` length;
  elsewhere, as in JAX's XLA, they run the module chain. The same holds on
  ``"ncl_fh"``.
- ``"ncl_fh"``: the JAX ``use_pallas_block="ncl_fh"`` route, the NCL route
  with the head fused into the block: blocks that JAX's NCL ``fusable``
  admits run K5 (``lvc_block_ncl_fh``; the last with the final-conv
  epilogue), the others K3 + K1 as on ``"ncl"``.
- ``"nwc"``: the JAX ``use_pallas_block=True`` route (``fastdiff_apply``'s
  NWC branch), (B, L, C) activations. Blocks that JAX's ``fusable`` admits
  (hops 64 and 256) run K7 (row-major head) and K6 (NWC block); the hop-8
  block runs the plain NWC loop with separate kernel and bias heads, as in
  JAX. With ``down_kernel`` (``use_pallas_down``) the first conv and the
  DBlocks run as K8 where JAX runs its kernel: bf16, three blocks and
  ``downpath_fusable(L)``; elsewhere they run the plain NWC ops.
- ``"plain"``: the JAX ``use_pallas_block=False`` route, the same NWC
  branch with every LVC block on the plain loop. It launches no kernel but
  K8, and that only where ``down_kernel`` asks for it, as in JAX.

Parameter names mirror the JAX tree from ``init_fastdiff``; weights are the
weight-norm-fused ones (``bridge.py`` converts a JAX tree). The kernels'
constant operands (merged head weights, stacked conv weights, final-conv
taps, down-path packs) are packed once, by ``pack``, for the model's route
when weights are set. A repack copies into the buffers it made the first
time, so ``load_state_dict`` keeps the storage of every parameter and
buffer, and a CUDA graph captured before it replays the new weights
(``diffusion/sampler.py:make_param_sampler``).

``use_kernels`` picks the implementation of every kernel of the route (the
LVC heads and blocks, and the down path): True calls the kernel wrappers
(CUDA kernels on the card, their plain versions on CPU tensors); False
calls the plain versions everywhere (on the NCL routes, the down path's
module chain).

``FastDiff(cfg, train_route=...)`` is the trainable model, the counterpart
of ``_fastdiff_apply_ncl(train_sr=True)`` and of the routes
``resolve_train_route`` picks. Every conv and transposed conv carries
weight norm as parameters ``v``, ``g`` and ``bias`` (``ops/nn.py:
conv_weight``; the dense layers have none); the head and block operands
are packed from them inside the graph on every call; the final conv runs
on its own, not as Kernel B's epilogue; and the LVC blocks run through the
route's autograd Function:

- ``ncl_sr``: Kernel A (``TaugHead``) and Kernel B-SR with the
  saved-residual backward (``LVCBlockSR``);
- ``ncl_vjp``: Kernel A and Kernel B with a recompute backward
  (``LVCBlockRecompute``);
- ``nwc_vjp``: JAX's ``use_pallas_block: true`` in training. Blocks that
  the NWC ``fusable`` admits (hop >= 64, at least 2 frames) run K7
  (``AugHead``) and K6 with a recompute backward
  (``LVCBlockNWCRecompute``) on NWC copies of x and skip, transposed back
  to NCL after the block (autograd carries the gradients through the
  transposes); every other block runs the plain head and block. The down
  path stays plain, as JAX trains it;
- ``plain``: autograd through the plain head and block.
"""

from __future__ import annotations

import torch
from torch import nn

from fastdiff_tpu_torch.config import ModelConfig
from fastdiff_tpu_torch.ops import downpath_pallas as down_ops
from fastdiff_tpu_torch.ops import lvc_block_ncl as block_ops
from fastdiff_tpu_torch.ops import lvc_block_pallas as nwc_ops
from fastdiff_tpu_torch.ops import lvc_head
from fastdiff_tpu_torch.ops import nn as fnn
from fastdiff_tpu_torch.ops.lvc import lvc_gated_residual_nwc


TRAIN_ROUTES = ("ncl_sr", "ncl_vjp", "nwc_vjp", "plain")
INFER_ROUTES = ("ncl", "ncl_fh", "nwc", "plain")
_TRUE = ("1", "true", "yes", "on")


def resolve_infer_route(hp: dict) -> str:
    """The inference route from ``use_pallas_block``, the jax-free
    counterpart of ``fastdiff_tpu/config.py:resolve_pallas_block``:

    - true (or "1", "yes", "on") -> "nwc": K6, K7 and, with
      ``use_pallas_down``, K8, as JAX runs its NWC kernels;
    - "ncl_fh" -> "ncl_fh": K5 on the blocks JAX fuses, K3 + K1 elsewhere;
    - "auto", "", "ncl", "ncl_sr", "ncl_vjp" -> "ncl" (JAX's "auto" picks
      its XLA path off the TPU because its kernels would run interpreted
      there; the port's kernels are native on the card);
    - false (and any other value) -> "plain", JAX's XLA path: the NWC
      forward with every LVC block on the plain loop."""
    raw = hp.get("use_pallas_block", "auto")
    if not isinstance(raw, str):
        return "nwc" if bool(raw) else "plain"
    low = raw.strip().lower()
    if low in _TRUE:
        return "nwc"
    if low == "ncl_fh":
        return "ncl_fh"
    if low in ("auto", "", "ncl", "ncl_sr", "ncl_vjp"):
        return "ncl"
    return "plain"


def checked_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card raises
    (the entry points never fall back to the CPU: ask for it by name)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for, but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev


def resolve_down_kernel(hp: dict) -> bool:
    """``use_pallas_down`` as ``fastdiff_tpu/config.py:resolve_pallas_down``
    parses it: "auto" or "" -> False, strings true when "1", "true", "yes"
    or "on", anything else by its truth value. Only the NWC route reads
    it, as in JAX."""
    raw = hp.get("use_pallas_down", "auto")
    if isinstance(raw, str):
        return raw.strip().lower() in _TRUE
    return bool(raw)


def resolve_train_route(hp: dict, device) -> str:
    """The LVC block route of training from ``use_pallas_block``, the
    counterpart of ``fastdiff_tpu/config.py:resolve_train_block``:
    "ncl_sr" and "ncl_vjp" as given; "auto" or "" -> "ncl_sr" on a CUDA
    device and "plain" on the CPU; true (or "1", "yes", "on") ->
    "nwc_vjp", K7 and K6 under autograd; false (and any other value) ->
    "plain"."""
    raw = hp.get("use_pallas_block", "auto")
    low = raw.strip().lower() if isinstance(raw, str) else raw
    if raw is True or low in _TRUE:
        return "nwc_vjp"
    if low in ("ncl_sr", "ncl_vjp"):
        return low
    if low in ("auto", ""):
        return "ncl_sr" if torch.device(device).type == "cuda" else "plain"
    return "plain"


def set_operand(module: nn.Module, name: str, value: torch.Tensor):
    """Set the packed operand ``name`` of ``module``: copied into the buffer
    already there when its shape, dtype and device match, so a reload keeps
    the storage that a captured CUDA graph (and a TMA map cached by
    pointer) reads; registered as a new non-persistent buffer otherwise."""
    old = module._buffers.get(name)
    if (old is not None and old.shape == value.shape
            and old.dtype == value.dtype and old.device == value.device):
        old.copy_(value)
    else:
        module.register_buffer(name, value, persistent=False)


class WNConv(nn.Module):
    """A conv's parameters under weight norm: ``v`` in PyTorch's layout
    ((O, I, K), or (I, O, K) for a transposed conv), ``g`` (v.shape[0],)
    and ``bias`` (O,). ``weight`` resolves g * v / ||v|| on every access."""

    def __init__(self, cin: int, cout: int, k: int, transpose: bool = False):
        super().__init__()
        shape = (cin, cout, k) if transpose else (cout, cin, k)
        self.transpose = transpose
        self.v = nn.Parameter(torch.empty(shape))
        self.g = nn.Parameter(torch.empty(shape[0]))
        self.bias = nn.Parameter(torch.empty(cout))

    @property
    def weight(self) -> torch.Tensor:
        fn = fnn.conv_transpose_weight if self.transpose else fnn.conv_weight
        return fn(self.v, self.g)


def _layers(weight_norm: bool):
    """(conv, transposed conv) constructors with PyTorch's signatures."""
    if not weight_norm:
        return nn.Conv1d, nn.ConvTranspose1d
    return WNConv, lambda cin, cout, k: WNConv(cin, cout, k, transpose=True)


def _conv_apply(conv: nn.Module, x, dtype, dilation: int = 1):
    return fnn.conv1d_ncl(conv.weight, conv.bias, x, dilation=dilation,
                          compute_dtype=dtype)


def _conv_apply_nwc(conv: nn.Module, x, dtype, dilation: int = 1):
    return fnn.conv1d_nwc(conv.weight, conv.bias, x, dilation=dilation,
                          compute_dtype=dtype)


class DBlock(nn.Module):
    """Nearest downsample + 3 dilated k=3 convs + 1x1 residual
    (``_dblock_apply_ncl``; the 1x1 conv runs after the downsample, which is
    exact since it is pointwise in time)."""

    def __init__(self, c: int, conv=nn.Conv1d):
        super().__init__()
        self.residual_dense = conv(c, c, 1)
        self.convs = nn.ModuleList([conv(c, c, 3) for _ in range(3)])

    def forward(self, x, factor: int, dtype):
        x = fnn.nearest_downsample_ncl(x, factor)
        residual = _conv_apply(self.residual_dense, x, dtype)
        for i, conv in enumerate(self.convs):
            x = _conv_apply(conv, fnn.leaky_relu(x, 0.2), dtype, 2 ** i)
        return x + residual

    def forward_nwc(self, x, factor: int, dtype):
        """``_dblock_apply`` on NWC activations (B, L, C)."""
        x = fnn.nearest_downsample_nwc(x, factor)
        residual = _conv_apply_nwc(self.residual_dense, x, dtype)
        for i, conv in enumerate(self.convs):
            x = _conv_apply_nwc(conv, fnn.leaky_relu(x, 0.2), dtype, 2 ** i)
        return x + residual


class KernelPredictor(nn.Module):
    """Conv trunk over the conditioning mel + the merged LVC kernel head."""

    def __init__(self, cfg: ModelConfig, conv=nn.Conv1d):
        super().__init__()
        c, hid, ksz = (cfg.inner_channels, cfg.kpnet_hidden_channels,
                       cfg.kpnet_conv_size)
        layers, k = cfg.lvc_layers_each_block, cfg.lvc_kernel_size
        self.input_conv = conv(cfg.cond_channels, hid, 5)
        self.residual_convs = nn.ModuleList(
            [conv(hid, hid, ksz) for _ in range(6)])
        # output channels in (layers, K, Cin, Cout) order
        self.kernel_conv = conv(hid, layers * k * c * 2 * c, ksz)
        self.bias_conv = conv(hid, layers * 2 * c, ksz)

    def trunk(self, cond, dtype):
        """``_kp_trunk``: cond (B, cond_ch, F) -> (B, hid, F)."""
        c = fnn.leaky_relu(_conv_apply(self.input_conv, cond, dtype), 0.1)
        r = c
        for conv in self.residual_convs:
            r = fnn.leaky_relu(_conv_apply(conv, r, dtype), 0.1)
        return c + r


class LVCBlock(nn.Module):
    """Time-aware LVC block (``_lvc_block_apply_ncl``)."""

    def __init__(self, cfg: ModelConfig, ratio: int, hop: int,
                 conv=nn.Conv1d, conv_t=nn.ConvTranspose1d):
        super().__init__()
        c = cfg.inner_channels
        self.ratio, self.hop = ratio, hop
        self.layers = cfg.lvc_layers_each_block
        self.upsample = conv_t(c, c, 2 * ratio)
        self.fc_t = nn.Linear(cfg.diffusion_step_embed_dim_out,
                              cfg.cond_channels)
        self.kernel_predictor = KernelPredictor(cfg, conv)
        self.convs = nn.ModuleList(
            [conv(c, c, cfg.lvc_kernel_size) for _ in range(self.layers)])

    def operands(self, dtype) -> tuple:
        """(w_head, b_head, wstack_t) packed from the current weights."""
        kp = self.kernel_predictor
        c = self.convs[0].bias.shape[0]
        w_head, b_head = lvc_head.pack_head(
            kp.kernel_conv.weight, kp.kernel_conv.bias, kp.bias_conv.weight,
            kp.bias_conv.bias, layers=self.layers, c=c, dtype=dtype)
        wstack_t = block_ops.stack_conv_weights(
            [cv.weight for cv in self.convs], [cv.bias for cv in self.convs],
            dtype=dtype)
        return w_head, b_head, wstack_t

    def nwc_operands(self, dtype) -> tuple:
        """(w_aug, b_aug, wstack) of the NWC route, K7's merged head and
        K6's conv weights, packed from the current weights."""
        kp = self.kernel_predictor
        c = self.convs[0].bias.shape[0]
        w_aug, b_aug = nwc_ops.pack_aug_head(
            kp.kernel_conv.weight, kp.kernel_conv.bias, kp.bias_conv.weight,
            kp.bias_conv.bias, layers=self.layers, c=c, dtype=dtype)
        wstack = nwc_ops.stack_conv_weights(
            [cv.weight for cv in self.convs], [cv.bias for cv in self.convs],
            dtype=dtype)
        return w_aug, b_aug, wstack

    @torch.no_grad()
    def pack(self, dtype, route: str = "ncl"):
        """Pack the kernel operands ``route`` reads (the plain route reads
        the weights as they are)."""
        if route == "plain":
            return
        names, operands = ((("w_head", "b_head", "wstack_t"),
                            self.operands(dtype)) if route != "nwc" else
                           (("w_aug", "b_aug", "wstack"),
                            self.nwc_operands(dtype)))
        for name, t in zip(names, operands):
            set_operand(self, name, t)

    def _trunk(self, mel, emb, dtype):
        """Predictor trunk (B, hid, F) over mel (B, n_mels, F) plus the
        step embedding's projection."""
        noise = fnn.dense(self.fc_t.weight, self.fc_t.bias, emb,
                          compute_dtype=dtype)                 # (B, cond) f32
        cond = mel + noise[:, :, None].to(mel.dtype)
        return self.kernel_predictor.trunk(cond, dtype)

    def _taps(self, mel, emb, dtype):
        """Predictor trunk taps (B*F, ksz*hid) in ``dtype``."""
        return lvc_head.head_taps(self._trunk(mel, emb, dtype).to(dtype))

    def _upsample(self, x, dtype):
        x = fnn.leaky_relu(x, 0.2)
        r = self.ratio
        x = fnn.conv_transpose1d_ncl(
            self.upsample.weight, self.upsample.bias, x, stride=r,
            torch_padding=r // 2 + r % 2, output_padding=r % 2,
            compute_dtype=dtype)
        return x.to(dtype).contiguous()

    def _upsample_nwc(self, x, dtype):
        x = fnn.leaky_relu(x, 0.2)
        r = self.ratio
        x = fnn.conv_transpose1d_nwc(
            self.upsample.weight, self.upsample.bias, x, stride=r,
            torch_padding=r // 2 + r % 2, output_padding=r % 2,
            compute_dtype=dtype)
        return x.to(dtype).contiguous()

    def _heads_nwc(self, mel, emb, dtype) -> tuple:
        """``_kernel_predictor_apply``: the separate kernel and bias heads
        -> kernels (B, F, layers, K, C, 2C), biases (B, F, layers, 2C), in
        ``dtype``."""
        b, _, frames = mel.shape
        kp = self.kernel_predictor
        c = self.convs[0].bias.shape[0]
        trunk = self._trunk(mel, emb, dtype)
        kw = _conv_apply(kp.kernel_conv, trunk, dtype).transpose(1, 2)
        kb = _conv_apply(kp.bias_conv, trunk, dtype).transpose(1, 2)
        return (kw.reshape(b, frames, self.layers, -1, c, 2 * c),
                kb.reshape(b, frames, self.layers, 2 * c))

    def forward_nwc(self, x, skip, mel, emb, dtype, use_kernels: bool,
                    fuse: bool = True):
        """``_lvc_block_apply``: x (B, L/ratio, C), skip (B, L, C), mel
        (B, n_mels, F) -> (B, L, C). With ``fuse``, blocks that ``fusable``
        admits run K7 and K6 (their plain versions without
        ``use_kernels``); the others the plain NWC loop, as in JAX."""
        b, _, frames = mel.shape
        c = self.convs[0].bias.shape[0]
        skip = skip.to(dtype)
        if fuse and nwc_ops.fusable(self.hop, frames):
            head = (nwc_ops.aug_head_matmul if use_kernels
                    else nwc_ops.aug_head_matmul_plain)
            kern_aug = head(self._taps(mel, emb, dtype), self.w_aug,
                            self.b_aug).reshape(b, frames, self.layers, -1,
                                                2 * c)
            block = (nwc_ops.lvc_block_nwc if use_kernels
                     else nwc_ops.lvc_block_nwc_plain)
            return block(self._upsample_nwc(x, dtype), skip.contiguous(),
                         kern_aug, self.wstack, self.hop)
        kernels, biases = self._heads_nwc(mel, emb, dtype)
        x = self._upsample_nwc(x, dtype)
        for i, conv in enumerate(self.convs):
            x = x + skip
            y = _conv_apply_nwc(conv, fnn.leaky_relu(x, 0.2), dtype, 3 ** i)
            x = lvc_gated_residual_nwc(x, fnn.leaky_relu(y, 0.2),
                                       kernels[:, :, i], biases[:, :, i].float(),
                                       self.hop)
        return x

    def forward(self, x, skip, mel, emb, dtype, use_kernels: bool,
                final_wb=None, fused_head: bool = False):
        """``_lvc_block_apply_ncl``: x (B, C, L/ratio), skip (B, C, L), mel
        (B, n_mels, F) -> (B, C, L), and the final conv's (B, 1, L) float32
        with ``final_wb``. With ``fused_head``, a block that the NCL
        ``fusable`` admits runs K5 where JAX runs ``lvc_block_ncl_fh``;
        every other block runs K3 + K1 (their plain versions without
        ``use_kernels``)."""
        b, _, frames = mel.shape
        c = self.convs[0].bias.shape[0]
        if (fused_head and block_ops.fusable(self.hop, frames)
                and 2 * c % 8 == 0):
            tap_c = lvc_head.frame_taps(self._trunk(mel, emb, dtype).to(dtype))
            block = (block_ops.lvc_block_ncl_fh if use_kernels
                     else block_ops.lvc_block_ncl_fh_plain)
            return block(self._upsample(x, dtype), skip.to(dtype).contiguous(),
                         tap_c, self.w_head, self.b_head, self.wstack_t,
                         self.hop, final_wb)
        tap = self._taps(mel, emb, dtype)
        head = (lvc_head.taug_head_matmul if use_kernels
                else lvc_head.taug_head_matmul_plain)
        kern = head(tap, self.w_head, self.b_head).reshape(
            b, frames, self.layers, 2 * c, -1)
        block = (block_ops.lvc_block_ncl if use_kernels
                 else block_ops.lvc_block_ncl_plain)
        return block(self._upsample(x, dtype), skip.to(dtype).contiguous(),
                     kern, self.wstack_t, self.hop, final_wb)

    def forward_train(self, x, skip, mel, emb, dtype, route: str):
        """The trainable block: operands packed in the graph, the head and
        block of ``route`` (see the module docstring)."""
        b, _, frames = mel.shape
        if route == "nwc_vjp":
            if nwc_ops.fusable(self.hop, frames):
                return self._forward_train_nwc(x, skip, mel, emb, dtype)
            route = "plain"
        w_head, b_head, wstack_t = self.operands(dtype)
        head = (lvc_head.taug_head_matmul_plain if route == "plain"
                else lvc_head.TaugHead.apply)
        kern = head(self._taps(mel, emb, dtype), w_head, b_head).reshape(
            b, frames, self.layers, 2 * self.convs[0].bias.shape[0], -1)
        args = (self._upsample(x, dtype), skip.to(dtype).contiguous(), kern,
                wstack_t, self.hop)
        if route == "ncl_sr":
            return block_ops.LVCBlockSR.apply(*args)
        if route == "ncl_vjp":
            return block_ops.LVCBlockRecompute.apply(*args)
        return block_ops.lvc_block_ncl_plain(*args)

    def _forward_train_nwc(self, x, skip, mel, emb, dtype):
        """The ``nwc_vjp`` block: K7 and K6 under autograd on (B, L, C)
        copies of the NCL activations; returns (B, C, L)."""
        b, _, frames = mel.shape
        c = self.convs[0].bias.shape[0]
        w_aug, b_aug, wstack = self.nwc_operands(dtype)
        kern_aug = nwc_ops.AugHead.apply(
            self._taps(mel, emb, dtype), w_aug, b_aug).reshape(
                b, frames, self.layers, -1, 2 * c)
        x_nwc = self._upsample(x, dtype).transpose(1, 2).contiguous()
        skip_nwc = skip.to(dtype).transpose(1, 2).contiguous()
        out = nwc_ops.LVCBlockNWCRecompute.apply(x_nwc, skip_nwc, kern_aug,
                                                 wstack, self.hop)
        return out.transpose(1, 2)


class FastDiff(nn.Module):
    """Epsilon model: ``forward(audio (B, T, 1), mel (B, T', n_mels),
    t (B, 1)) -> (B, T, 1)`` float32, T == T' * prod(upsample_ratios).

    ``infer_route`` (one of ``INFER_ROUTES``) and ``down_kernel`` pick the
    inference route (module docstring); ``train_route`` makes the trainable
    model."""

    def __init__(self, cfg: ModelConfig = ModelConfig(), *,
                 seed: int | None = 0, device=None,
                 train_route: str | None = None, infer_route: str = "ncl",
                 down_kernel: bool = False):
        super().__init__()
        if cfg.audio_channels != 1:
            raise ValueError("the FastDiff forward needs audio_channels == 1")
        if train_route is not None and train_route not in TRAIN_ROUTES:
            raise ValueError(f"train_route {train_route!r} is not one of "
                             f"{TRAIN_ROUTES}")
        if infer_route not in INFER_ROUTES:
            raise ValueError(f"infer_route {infer_route!r} is not one of "
                             f"{INFER_ROUTES}")
        if train_route is not None and infer_route != "ncl":
            raise ValueError("a trainable model (train_route) takes its "
                             "route from train_route, not infer_route")
        self.cfg = cfg
        self.dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                      else torch.float32)
        self.use_kernels = True
        self.train_route = train_route
        self.infer_route = infer_route
        self.down_kernel = down_kernel
        conv, conv_t = _layers(train_route is not None
                               and cfg.use_weight_norm)
        c = cfg.inner_channels
        self.first_audio_conv = conv(cfg.audio_channels, c, 7)
        self.final_conv = conv(c, cfg.audio_channels, 7)
        self.fc_t1 = nn.Linear(cfg.diffusion_step_embed_dim_in,
                               cfg.diffusion_step_embed_dim_mid)
        self.fc_t2 = nn.Linear(cfg.diffusion_step_embed_dim_mid,
                               cfg.diffusion_step_embed_dim_out)
        self.lvc_blocks = nn.ModuleList(
            [LVCBlock(cfg, r, hop, conv, conv_t) for r, hop in
             zip(cfg.upsample_ratios, cfg.cond_hop_lengths)])
        # downsample[n] shrinks by the reversed ratio order
        self.downsample = nn.ModuleList(
            [DBlock(c, conv) for _ in cfg.upsample_ratios])
        if seed is not None:
            self.init_weights(torch.Generator().manual_seed(seed))
        self.pack()
        if device is not None:
            self.to(device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Random init with the JAX package's distributions (torch defaults:
        U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias; fan_in is
        O*K for a transposed conv). Weight norm starts at g = ||v||, so the
        fused weight equals v."""
        for module in self.modules():
            if isinstance(module, WNConv):
                # fan_in is v[0].numel() for both layouts: I*K and O*K
                bound = module.v[0].numel() ** -0.5
                module.v.uniform_(-bound, bound, generator=generator)
                module.bias.uniform_(-bound, bound, generator=generator)
                module.g.copy_(module.v.flatten(1).norm(dim=1))
                continue
            if isinstance(module, nn.ConvTranspose1d):
                fan_in = module.weight.shape[1] * module.weight.shape[2]
            elif isinstance(module, (nn.Conv1d, nn.Linear)):
                fan_in = module.weight[0].numel()
            else:
                continue
            bound = fan_in ** -0.5
            module.weight.uniform_(-bound, bound, generator=generator)
            module.bias.uniform_(-bound, bound, generator=generator)
        self.pack()

    @torch.no_grad()
    def pack(self):
        """Pack the kernels' constant operands from the current weights
        (inference only: the trainable model packs on every call)."""
        if self.train_route is not None:
            return
        for block in self.lvc_blocks:
            block.pack(self.dtype, self.infer_route)
        if self.infer_route in ("ncl", "ncl_fh"):
            set_operand(self, "final_wb", block_ops.final_conv_wb(
                self.final_conv.weight, self.final_conv.bias, self.dtype))
            if self._down_ncl_widths():
                packs = (*down_ops.pack_downpath_weights(
                    self.first_audio_conv, self.downsample),
                    down_ops.pack_downpath_bias(self.first_audio_conv,
                                                self.downsample))
                for name, t in zip(("down_first", "down_res", "down_conv",
                                    "down_bias"), packs):
                    set_operand(self, name, t)
        elif self.down_kernel:
            for name, t in zip(("down_first", "down_res", "down_conv"),
                               down_ops.pack_downpath_weights(
                                   self.first_audio_conv, self.downsample)):
                set_operand(self, name, t)

    def load_state_dict(self, state_dict, strict: bool = True, assign=False):
        result = super().load_state_dict(state_dict, strict=strict,
                                         assign=assign)
        self.pack()
        return result

    def _embed(self, t):
        """The diffusion-step embedding MLP: t (B, 1) -> (B, dim_out) f32."""
        emb = fnn.diffusion_step_embedding(
            t, self.cfg.diffusion_step_embed_dim_in)
        emb = fnn.swish(fnn.dense(self.fc_t1.weight, self.fc_t1.bias, emb))
        return fnn.swish(fnn.dense(self.fc_t2.weight, self.fc_t2.bias, emb))

    def _down_ncl_widths(self) -> bool:
        """Whether K8's NCL layout is built for this model's down path:
        the inference model in bf16 with C = 32 and factors (4, 8, 8) (the
        first conv's 7 taps and a DBlock's 3 convs are the model's own)."""
        return (self.train_route is None and self.dtype == torch.bfloat16
                and self.cfg.inner_channels == down_ops.KERNEL_CHANNELS
                and tuple(self.cfg.upsample_ratios[::-1])
                == down_ops.KERNEL_FACTORS)

    def _down_path(self, audio, mel, t):
        """Step embedding, audio conv and DBlocks -> (emb, x, skips in LVC
        block order, mel (B, n_mels, F) in the compute dtype). The NCL
        inference routes run K8's NCL layout (``downpath_ncl``) where the
        widths allow it, ``use_kernels`` is set, the audio is float32 and
        its length ``downpath_fusable``; everything else (the trainable
        model too) runs the module chain."""
        cfg, dtype = self.cfg, self.dtype
        emb = self._embed(t)
        mel_ncl = mel.to(dtype).transpose(1, 2)
        b, length, _ = audio.shape
        factors = tuple(cfg.upsample_ratios[::-1])
        if (self.use_kernels and self.infer_route in ("ncl", "ncl_fh")
                and self._down_ncl_widths() and audio.dtype == torch.float32
                and down_ops.downpath_fusable(length, factors)):
            *skips, x = down_ops.downpath_ncl(
                audio.contiguous(), self.down_first, self.down_res,
                self.down_conv, self.down_bias, factors)
            return emb, x, skips[::-1], mel_ncl
        x = _conv_apply(self.first_audio_conv,
                        audio.to(dtype).reshape(b, 1, length), dtype)
        skips = []
        for dblock, factor in zip(self.downsample, factors):
            skips.append(x)
            x = dblock(x, factor, dtype)
        return emb, x, skips[::-1], mel_ncl

    def forward(self, audio: torch.Tensor, mel: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
        if self.train_route is not None:
            return self._forward_train(audio, mel, t)
        if self.infer_route in ("nwc", "plain"):
            return self._forward_nwc(audio, mel, t)
        dtype = self.dtype
        b, length, _ = audio.shape
        emb, x, skips, mel_ncl = self._down_path(audio, mel, t)
        n_blocks = len(self.lvc_blocks)
        fused_head = self.infer_route == "ncl_fh"
        for n, (block, skip) in enumerate(zip(self.lvc_blocks, skips)):
            last = n == n_blocks - 1
            x = block(x, skip, mel_ncl, emb, dtype, self.use_kernels,
                      self.final_wb if last else None, fused_head)
        _, fin = x
        return fin.reshape(b, length, 1)

    def _down_path_nwc(self, audio):
        """The NWC down path -> (x, skips in LVC block order), (B, L_r, C).
        K8 (its plain version without ``use_kernels``) where JAX runs its
        down-path kernel: ``down_kernel``, bf16, three blocks and a
        ``downpath_fusable`` length; the plain NWC ops elsewhere."""
        dtype = self.dtype
        factors = tuple(self.cfg.upsample_ratios[::-1])
        if (self.down_kernel and len(factors) == 3
                and dtype == torch.bfloat16
                and down_ops.downpath_fusable(audio.shape[1], factors)):
            fn = (down_ops.downpath_fused if self.use_kernels
                  else down_ops.downpath_plain)
            *skips, x = fn(audio.float().contiguous(), self.down_first,
                           self.down_res, self.down_conv, factors)
            return x, skips[::-1]
        x = _conv_apply_nwc(self.first_audio_conv, audio.to(dtype), dtype)
        skips = []
        for dblock, factor in zip(self.downsample, factors):
            skips.append(x)
            x = dblock.forward_nwc(x, factor, dtype)
        return x, skips[::-1]

    def _forward_nwc(self, audio, mel, t):
        """``fastdiff_apply``'s NWC branch: ``use_pallas_block=True`` on the
        "nwc" route, ``False`` (no block fused) on the "plain" route."""
        dtype = self.dtype
        emb = self._embed(t)
        x, skips = self._down_path_nwc(audio)
        mel_ncl = mel.to(dtype).transpose(1, 2)
        fuse = self.infer_route == "nwc"
        for block, skip in zip(self.lvc_blocks, skips):
            x = block.forward_nwc(x, skip, mel_ncl, emb, dtype,
                                  self.use_kernels, fuse)
        return _conv_apply_nwc(self.final_conv, x, dtype).float()

    def _forward_train(self, audio, mel, t):
        dtype = self.dtype
        b, length, _ = audio.shape
        emb, x, skips, mel_ncl = self._down_path(audio, mel, t)
        for block, skip in zip(self.lvc_blocks, skips):
            x = block.forward_train(x, skip, mel_ncl, emb, dtype,
                                    self.train_route)
        out = _conv_apply(self.final_conv, x, dtype)
        return out.float().reshape(b, length, 1)


def num_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
