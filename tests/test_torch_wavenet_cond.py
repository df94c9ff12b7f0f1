"""DiffWave's per-block mel conditioning (``ops/wavenet_cond.py``) and the
stages of ``csrc/wavenet_cond.cuh`` that build it in the block kernel.

On the CPU: the plain version against the module chain ``models/wavenet.py``
ran before it had the op (bit for bit); ``WaveNet``'s route with gradients
off against its route with gradients on at widths the block kernel
declines; a Python model of the stages' tile walk at the block kernel's
tile (``ops/wavenet_block.py:TILE``: the mel frames, stage-1 positions and
stride-group halves each tile reaches, its f32 sums in the stages' order)
against the plain conditioning, bit for bit on data whose every f32 sum is
exact and within rare rounding flips on random data; the stages' rows
covering every tile.

The block kernel's card tests are in ``test_torch_wavenet_block.py``.
"""

import pytest
import torch
import torch.nn.functional as F

from fastdiff_tpu_torch.models.wavenet import WaveNet, WaveNetConfig
from fastdiff_tpu_torch.ops import wavenet_block as wb
from fastdiff_tpu_torch.ops import wavenet_cond as wc

M = 80


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _chain(h, mel, ups, mel_w, mel_b, stride, dtype):
    """The module chain as ``WaveNet.forward`` ran it before the op: each
    upsampler's transposed conv on float32 copies, its bias, leaky ReLU
    0.4; the crop; ``conv1d_ncl`` of the 1x1 projection; the add."""
    cond = mel.to(dtype).transpose(1, 2)[:, None]
    for w, b in ups:
        y = F.conv_transpose2d(cond.float(), w.to(dtype).float(),
                               stride=(1, stride),
                               padding=(1, stride // 2)).to(dtype)
        y = y + b.to(dtype)
        cond = torch.where(y >= 0, y, 0.4 * y).to(dtype)
    cond = cond[:, 0, :, :h.shape[-1]]
    y = F.conv1d(cond.float(), mel_w.to(dtype).float(), mel_b.float())
    return h + y.to(dtype)


def _operands(gen, batch, ch2, frames, length, stride, dtype, exact=False):
    """(h, mel, ups, mel_w, mel_b). ``exact``: few-bit values (mel and the
    upsamplers' taps non-negative, their biases at least 1/8) for which
    every f32 sum of the chain is exact, so any summation order gives the
    same bits."""
    def draw(shape, lo, hi, scale):
        return torch.randint(lo, hi, shape, generator=gen).float() * scale

    if exact:
        mel = draw((batch, frames, M), 0, 9, 0.25)
        ups = [(draw((1, 1, 3, 2 * stride), 0, 5, 0.125),
                draw((1,), 1, 3, 0.125)) for _ in range(2)]
        mel_w = draw((ch2, M, 1), -4, 5, 0.125)
        mel_b = draw((ch2,), -8, 9, 0.125)
    else:
        mel = torch.randn((batch, frames, M), generator=gen) - 4.0
        ups = [(torch.randn((1, 1, 3, 2 * stride), generator=gen)
                * (2.0 / (6 * stride)) ** 0.5,
                0.1 * torch.randn((1,), generator=gen)) for _ in range(2)]
        mel_w = torch.randn((ch2, M, 1), generator=gen) * M ** -0.5
        mel_b = 0.1 * torch.randn((ch2,), generator=gen)
    h = torch.randn((batch, ch2, length), generator=gen).to(dtype)
    return h, mel.to(dtype).contiguous(), ups, mel_w, mel_b


def _bf(x):
    return x.to(torch.bfloat16).float()


def _act(raw, bias):
    v = _bf(_bf(raw) + bias)
    return torch.where(v >= 0, v, _bf(0.4 * v))


def _tile_model(mel, ups, stride, length):
    """``csrc/wavenet_cond.cuh`` in Python, tile by tile at the block
    kernel's ``TILE``: the staged mel frames F0 .., upsampler 1 at the NP
    stage-1 positions P0 .., upsampler 2 by stride-group halves, each sum of
    products in the stages' order (a product of two bf16 values is exact in
    f32, so acc + a * b is the kernel's fmaf). Returns the conditioning (B,
    M, L), bf16 values in f32."""
    s, tile = stride, wb.TILE
    batch, frames = mel.shape[:2]
    n_p, n_f = wb.stage1_rows(s), wb.mel_frames(s)
    (w1, b1), (w2, b2) = ups
    w1, w2 = _bf(w1).reshape(3, 2 * s), _bf(w2).reshape(3, 2 * s)
    b1, b2 = _bf(b1), _bf(b2)
    melf = mel.float()
    out = torch.empty(batch, M, length)
    for j0 in range(0, length, tile):
        p0 = j0 // s - 1
        f0 = (p0 + s // 2) // s - 1
        ms = torch.zeros(batch, n_f, M + 2)
        for f in range(n_f):
            if 0 <= f0 + f < frames:
                ms[:, f, 1:M + 1] = melf[:, f0 + f]
        us = torch.zeros(batch, n_p, M + 2)
        for pl in range(n_p):
            p = p0 + pl
            if not 0 <= p < frames * s:
                continue
            x = p + s // 2
            r, fl = x % s, x // s - f0
            assert 1 <= fl < n_f, "a frame outside the staged ones"
            acc = torch.zeros(batch, M)
            for kh in range(3):
                acc = acc + ms[:, fl, 2 - kh:2 - kh + M] * w1[kh, r]
                acc = acc + ms[:, fl - 1, 2 - kh:2 - kh + M] * w1[kh, r + s]
            us[:, pl, 1:M + 1] = _act(acc, b1)
        cond = torch.zeros(batch, tile, M)
        for m in range(tile // s):
            for t in range(s):
                half = int(t >= s // 2)
                r = t - s // 2 if half else t + s // 2
                qa, qb = us[:, m + 1 + half], us[:, m + half]
                acc = torch.zeros(batch, M)
                for kh in range(3):
                    acc = acc + qa[:, 2 - kh:2 - kh + M] * w2[kh, r]
                    acc = acc + qb[:, 2 - kh:2 - kh + M] * w2[kh, r + s]
                cond[:, m * s + t] = _act(acc, b2)
        n = min(tile, length - j0)
        out[:, :, j0:j0 + n] = cond[:, :n].transpose(1, 2)
    return out


def _plain_cond(mel, ups, stride, length):
    """The plain version's conditioning alone: h zero and the identity for
    the projection, both exact on bf16 values."""
    h = torch.zeros(mel.shape[0], M, length, dtype=torch.bfloat16)
    return wc.wavenet_cond_plain(h, mel, ups, torch.eye(M)[:, :, None],
                                 torch.zeros(M), stride=stride).float()


# frames, and a length short of frames * s^2 that is no multiple of a tile
CASES = [(16, 5, 5 * 256 - 40), (8, 9, 9 * 64 - 24)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("stride,frames,length", CASES)
def test_plain_equals_the_module_chain(stride, frames, length, dtype):
    gen = torch.Generator().manual_seed(stride)
    h, mel, ups, mel_w, mel_b = _operands(gen, 2, 64, frames, length,
                                          stride, dtype)
    got = wc.wavenet_cond_plain(h, mel, ups, mel_w, mel_b, stride=stride)
    want = _chain(h, mel, ups, mel_w, mel_b, stride, dtype)
    assert got.dtype == dtype and got.shape == h.shape
    assert torch.equal(got, want)


def _small_wavenet(multiband):
    cfg = WaveNetConfig(res_channels=32, skip_channels=32, num_res_layers=3,
                        dilation_cycle=2, noise_scale_embed_dim_in=16,
                        noise_scale_embed_dim_mid=32,
                        noise_scale_embed_dim_out=32, multiband=multiband)
    model = WaveNet(cfg, seed=0)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():     # a non-zero output conv (seed weights zero it)
        model.out_conv.weight.normal_(generator=gen)
    return model


@pytest.mark.parametrize("multiband", [False, True])
def test_no_grad_route_equals_the_grad_route(multiband, monkeypatch):
    """At widths the block kernel declines (32 channels) both routes run
    the plain conditioning once a block, and give the same output."""
    model = _small_wavenet(multiband)
    assert not model.block_kernel
    s = model.cfg.upsample_strides[0]
    frames = 3
    gen = torch.Generator().manual_seed(6)
    audio = torch.randn((2, frames * s * s, 1), generator=gen)
    mel = torch.randn((2, frames, M), generator=gen) - 4.0
    t = torch.tensor([[3.0], [17.5]])
    calls = []
    op = wc.wavenet_cond_plain
    monkeypatch.setattr(wc, "wavenet_cond_plain",
                        lambda *a, **k: calls.append(1) or op(*a, **k))
    with_grad = model(audio, mel, t)
    assert with_grad.requires_grad
    assert len(calls) == model.cfg.num_res_layers
    with torch.no_grad():
        without = model(audio, mel, t)
    assert len(calls) == 2 * model.cfg.num_res_layers
    assert torch.equal(without, with_grad.detach())
    assert float(without.abs().max()) > 0


@pytest.mark.parametrize("stride,frames,length", CASES + [(16, 3, 768)])
def test_tile_model_is_the_plain_version_on_exact_data(stride, frames,
                                                       length):
    gen = torch.Generator().manual_seed(7 + stride)
    _, mel, ups, _, _ = _operands(gen, 2, 64, frames, length, stride,
                                  torch.bfloat16, exact=True)
    assert torch.equal(_tile_model(mel, ups, stride, length),
                       _plain_cond(mel, ups, stride, length))


@pytest.mark.parametrize("stride,frames,length", CASES)
def test_tile_model_flips_rarely_on_random_data(stride, frames, length):
    """On random data the two differ only where a differently ordered f32
    sum rounds to the other side of a bf16 step: each conditioning value
    of the model and of the plain version may differ by one bf16 ulp in a
    few places in a thousand, never more."""
    gen = torch.Generator().manual_seed(11 + stride)
    _, mel, ups, _, _ = _operands(gen, 2, 64, frames, length, stride,
                                  torch.bfloat16)
    got = _tile_model(mel, ups, stride, length)
    want = _plain_cond(mel, ups, stride, length)
    assert float((got - want).norm() / want.norm()) < 1e-3
    assert float((got != want).float().mean()) < 1e-2


def test_stage_geometry_covers_every_tile():
    """The staged frames and stage-1 rows cover what every tile of the
    block kernel reads, at any tile position (the model's asserts check the
    same on its data)."""
    for s in wb.STRIDES:
        n_p, n_f = wb.stage1_rows(s), wb.mel_frames(s)
        for j0 in range(0, 64 * wb.TILE, wb.TILE):
            p0 = j0 // s - 1
            f0 = (p0 + s // 2) // s - 1
            frames = {q for p in range(p0, p0 + n_p)
                      for q in ((p + s // 2) // s, (p + s // 2) // s - 1)}
            assert min(frames) >= f0 and max(frames) < f0 + n_f
            # stage 2 reads rows m .. m + 2 of each stride group m
            assert wb.TILE // s + 1 < n_p
