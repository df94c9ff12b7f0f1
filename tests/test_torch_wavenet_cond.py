"""DiffWave's per-block mel conditioning (``ops/wavenet_cond.py``).

On the CPU: the plain version against the module chain ``models/wavenet.py``
ran before it had the op (bit for bit); ``WaveNet``'s route with gradients
off against its route with gradients on; a Python model of the kernel's
tile walk (``csrc/wavenet_cond.cu``: the mel frames, stage-1 positions and
stride-group halves each tile reaches, its f32 sums in the kernel's order)
against the plain version, bit for bit on data whose every f32 sum is exact
and within rare rounding flips on random data; the wrapper's geometry and C
entry against the source.

On a card (``-m card``; no JAX is imported here, so the card's machine can
run the file with ``python3 -m pytest --confcutdir=tests -c /dev/null
tests/test_torch_wavenet_cond.py -m card``): the kernel against the plain
version at the DiffWave cell's shape and at a multiband shape (within one
ulp of the projection and one rounding of h), bit for bit on exact data;
the launches of one captured N = 6 sampler call (DiffWave BASE's blocks now
run the block kernel, ``ops/wavenet_block.py``) and of a training step;
``WaveNet`` refusing a length the kernel does not take.
"""

import math
import re

import pytest
import torch
import torch.nn.functional as F

from fastdiff_tpu_torch.ops import _build
from fastdiff_tpu_torch.ops import wavenet_cond as wc
from fastdiff_tpu_torch.models.wavenet import WaveNet, WaveNetConfig

M = 80


@pytest.fixture
def card():
    """The first CUDA card; skips the test where there is none (decided
    when the test runs, never when a module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda:0")


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


def _operands(gen, batch, ch2, frames, length, stride, dtype,
              exact=False, device="cpu"):
    """(h, mel, ups, mel_w, mel_b). ``exact``: few-bit values (mel and the
    upsamplers' taps non-negative, their biases at least 1/8) for which
    every f32 sum of the chain is exact, so any summation order gives the
    same bits."""
    def draw(shape, lo, hi, scale):
        return (torch.randint(lo, hi, shape, generator=gen).float()
                * scale).to(device)

    if exact:
        mel = draw((batch, frames, M), 0, 9, 0.25)
        ups = [(draw((1, 1, 3, 2 * stride), 0, 5, 0.125),
                draw((1,), 1, 3, 0.125)) for _ in range(2)]
        mel_w = draw((ch2, M, 1), -4, 5, 0.125)
        mel_b = draw((ch2,), -8, 9, 0.125)
    else:
        mel = (torch.randn((batch, frames, M), generator=gen) - 4.0).to(device)
        ups = [((torch.randn((1, 1, 3, 2 * stride), generator=gen)
                 * (2.0 / (6 * stride)) ** 0.5).to(device),
                (0.1 * torch.randn((1,), generator=gen)).to(device))
               for _ in range(2)]
        mel_w = (torch.randn((ch2, M, 1), generator=gen) * M ** -0.5) \
            .to(device)
        mel_b = (0.1 * torch.randn((ch2,), generator=gen)).to(device)
    h = torch.randn((batch, ch2, length), generator=gen).to(device, dtype)
    return h, mel.to(dtype).contiguous(), ups, mel_w, mel_b


def _bf(x):
    return x.to(torch.bfloat16).float()


def _act(raw, bias):
    v = _bf(_bf(raw) + bias)
    return torch.where(v >= 0, v, _bf(0.4 * v))


def _tile_model(h, mel, ups, mel_w, mel_b, stride):
    """``csrc/wavenet_cond.cu`` in Python: tile by tile, the staged mel
    frames F0 .., upsampler 1 at the NP stage-1 positions P0 .., upsampler
    2 by stride-group halves, each sum of products in the kernel's order
    (a product of two bf16 values is exact in f32, so acc + a * b is the
    kernel's fmaf), then the projection and the add."""
    s, tile = stride, wc.TILE
    batch, ch2, length = h.shape
    frames = mel.shape[1]
    n_p, n_f = wc.stage1_rows(s), wc.mel_frames(s)
    (w1, b1), (w2, b2) = ups
    w1, w2 = _bf(w1).reshape(3, 2 * s), _bf(w2).reshape(3, 2 * s)
    b1, b2 = _bf(b1), _bf(b2)
    wm = _bf(mel_w.reshape(ch2, M))
    melf = mel.float()
    out = h.clone()
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
        y = _bf(cond[:, :n] @ wm.T + mel_b.float())          # (B, n, 2C)
        out[:, :, j0:j0 + n] = (h[:, :, j0:j0 + n].float()
                                + y.transpose(1, 2)).to(h.dtype)
    return out


# frames, and a length short of frames * s^2 that is no multiple of a tile
CASES = [(16, 5, 5 * 256 - 40), (8, 9, 9 * 64 - 24)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("stride,frames,length", CASES)
def test_plain_equals_the_module_chain(stride, frames, length, dtype):
    gen = torch.Generator().manual_seed(stride)
    h, mel, ups, mel_w, mel_b = _operands(gen, 2, 64, frames, length,
                                          stride, dtype)
    got = wc.wavenet_cond(h, mel, ups, mel_w, mel_b, stride=stride)
    want = _chain(h, mel, ups, mel_w, mel_b, stride, dtype)
    assert got.dtype == dtype and got.shape == h.shape
    assert torch.equal(got, want)


def _small_wavenet(multiband, dtype="bfloat16"):
    cfg = WaveNetConfig(res_channels=32, skip_channels=32, num_res_layers=3,
                        dilation_cycle=2, noise_scale_embed_dim_in=16,
                        noise_scale_embed_dim_mid=32,
                        noise_scale_embed_dim_out=32, multiband=multiband,
                        compute_dtype=dtype)
    model = WaveNet(cfg, seed=0)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():     # a non-zero output conv (seed weights zero it)
        model.out_conv.weight.normal_(generator=gen)
    return model


@pytest.mark.parametrize("multiband", [False, True])
def test_no_grad_route_equals_the_grad_route(multiband, monkeypatch):
    model = _small_wavenet(multiband)
    assert model.cond_kernel
    s = model.cfg.upsample_strides[0]
    frames = 3
    gen = torch.Generator().manual_seed(6)
    audio = torch.randn((2, frames * s * s, 1), generator=gen)
    mel = torch.randn((2, frames, M), generator=gen) - 4.0
    t = torch.tensor([[3.0], [17.5]])
    calls = []
    op = wc.wavenet_cond
    monkeypatch.setattr(wc, "wavenet_cond",
                        lambda *a, **k: calls.append(1) or op(*a, **k))
    with_grad = model(audio, mel, t)
    assert with_grad.requires_grad and not calls
    with torch.no_grad():
        without = model(audio, mel, t)
    assert len(calls) == model.cfg.num_res_layers
    assert torch.equal(without, with_grad.detach())
    assert float(without.abs().max()) > 0


def test_route_by_widths_dtype_and_length():
    assert wc.supports(128, 80, 16, torch.bfloat16)      # DiffWave BASE
    assert wc.supports(256, 80, 8, torch.bfloat16)
    for args in ((16, 80, 16, torch.bfloat16), (96, 80, 16, torch.bfloat16),
                 (320, 80, 16, torch.bfloat16), (128, 64, 16, torch.bfloat16),
                 (128, 80, 4, torch.bfloat16), (128, 80, 16, torch.float32)):
        assert not wc.supports(*args), args
    assert wc.fits_length(896 * 256, 896, 16)
    assert wc.fits_length(8, 1, 16)
    assert not wc.fits_length(896 * 256 + 8, 896, 16)
    assert not wc.fits_length(100, 1, 16)
    assert not wc.fits_length(0, 1, 16)
    assert not _small_wavenet(False, "float32").cond_kernel
    assert not WaveNet(WaveNetConfig(res_channels=8, skip_channels=8,
                                     num_res_layers=1), seed=0).cond_kernel
    assert WaveNet(WaveNetConfig(num_res_layers=1), seed=0).cond_kernel


@pytest.mark.parametrize("stride,frames,length", CASES + [(16, 3, 768)])
def test_tile_model_is_the_plain_version_on_exact_data(stride, frames,
                                                       length):
    gen = torch.Generator().manual_seed(7 + stride)
    ops = _operands(gen, 2, 64, frames, length, stride, torch.bfloat16,
                    exact=True)
    assert torch.equal(_tile_model(*ops, stride),
                       wc.wavenet_cond_plain(*ops, stride=stride))


@pytest.mark.parametrize("stride,frames,length", CASES)
def test_tile_model_flips_rarely_on_random_data(stride, frames, length):
    """On random data the two differ only where a differently ordered f32
    sum rounds to the other side of a bf16 step: each conditioning value
    of the model and of the plain version, computed alike from the same
    stage-1 values, may differ by one bf16 ulp in a few places in a
    thousand, never more."""
    gen = torch.Generator().manual_seed(11 + stride)
    h, mel, ups, mel_w, mel_b = _operands(gen, 2, 64, frames, length, stride,
                                          torch.bfloat16)
    got = _tile_model(h, mel, ups, mel_w, mel_b, stride).float()
    want = wc.wavenet_cond_plain(h, mel, ups, mel_w, mel_b,
                                 stride=stride).float()
    assert float((got - want).norm() / want.norm()) < 1e-3
    assert float((got != want).float().mean()) < 1e-2


def _source() -> str:
    return (_build.CSRC / "wavenet_cond.cu").read_text()


def test_python_geometry_matches_the_source():
    src = _source()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("TILE") == wc.TILE
    assert const("BLOCKS_PER_SM") == wc.BLOCKS_PER_SM
    assert const("CH_TILE") == wc.CH_TILE
    assert const("MAX_CH2") == wc.MAX_CH2
    assert const("NM") == wc.N_MELS
    assert re.search(r"constexpr int CROW = NM \+ 8;", src)
    assert re.search(r"constexpr int HROW = TILE \+ 8;", src)
    assert re.search(r"constexpr int UROW = NM \+ 2;", src)
    assert wc.CROW == wc.N_MELS + 8 and wc.HROW == wc.TILE + 8
    assert wc.UROW == wc.N_MELS + 2
    assert re.search(r"static constexpr int NP = TILE / S \+ 2;", src)
    assert re.search(r"static constexpr int NF = \(NP - 1\) / S \+ 3;", src)
    body = re.search(r"constexpr int smem_bytes\(int ch2\) \{\s*return "
                     r"([^;]*);", src).group(1)
    assert " ".join(body.split()) == (
        "ch2 * (2 * CROW + 2 * HROW + 4) + 2 * TILE * CROW + "
        "4 * (2 * 3 * 2 * S) + 16 + 4 * UROW * (Geo<S>::NP + Geo<S>::NF)")
    for s in wc.STRIDES:
        assert re.search(rf"stride == {s}\)\s*return launch<{s}>", src)


def test_stage_geometry_covers_every_tile():
    """The staged frames and stage-1 rows cover what every tile reads, at
    any tile position (the model's asserts check the same on its data)."""
    for s in wc.STRIDES:
        n_p, n_f = wc.stage1_rows(s), wc.mel_frames(s)
        for j0 in range(0, 64 * wc.TILE, wc.TILE):
            p0 = j0 // s - 1
            f0 = (p0 + s // 2) // s - 1
            frames = {q for p in range(p0, p0 + n_p)
                      for q in ((p + s // 2) // s, (p + s // 2) // s - 1)}
            assert min(frames) >= f0 and max(frames) < f0 + n_f
            # stage 2 reads rows m .. m + 2 of each stride group m
            assert wc.TILE // s + 1 < n_p


def test_entry_arity_and_shared_memory():
    arity = re.search(r'extern "C" int wavenet_cond_launch\(([^)]*)\)',
                      _source()).group(1).count(",") + 1
    assert arity == len(_build.SIGNATURES["wavenet_cond_launch"]) == 17
    for s in wc.STRIDES:
        # two blocks an SM at DiffWave BASE's 2C = 128, one at 256
        assert 2 * (wc.smem_bytes(128, s) + wc.SMEM_RESERVED) <= wc.SMEM_PER_SM
        assert wc.smem_bytes(wc.MAX_CH2, s) + wc.SMEM_RESERVED <= \
            wc.SMEM_PER_SM
        assert wc.launch_grid(16, 896 * 256, 128, s, 132) == 264
        assert wc.launch_grid(1, 256, 128, s, 132) == 2
        assert wc.launch_grid(1, 2 * 8 * wc.TILE, 256, s, 4) == 4


def test_cuda_wrapper_refuses_before_launching():
    """Refusals that need no card: a device that is neither CPU nor CUDA."""
    h = torch.zeros((1, 64, 256), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        wc.wavenet_cond(h, h, [], None, None, stride=16)


def _ulp(x):
    """One bf16 ulp at |x| (2^-133 at 0)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


SHAPES = [(16, 896, 16), (4, 864, 8)]     # the DiffWave cell's; multiband


@pytest.mark.card
@pytest.mark.parametrize("batch,frames,stride", SHAPES)
def test_kernel_matches_plain_on_card(card, batch, frames, stride):
    """Each value within one bf16 ulp of the projection y plus one rounding
    of h, and a relative L2 under 1e-3. The conditioning is cuDNN's bit for
    bit (the kernel sums each output's six products in cuDNN's order); the
    tensor cores sum the projection's 80 products in another order than
    cuDNN's 1x1 conv, so y may round one ulp the other way, and then
    h_in + y, where it falls on a tie, may round the other way too: two
    steps of ulp(|h_in| + |h_out|), which is at least ulp(y) and ulp(h)."""
    gen = torch.Generator().manual_seed(batch + stride)
    length = frames * stride * stride
    h, mel, ups, mel_w, mel_b = _operands(gen, batch, 128, frames, length,
                                          stride, torch.bfloat16,
                                          device=card)
    with torch.inference_mode():
        want = wc.wavenet_cond_plain(h, mel, ups, mel_w, mel_b,
                                     stride=stride).float()
        before = wc.LAUNCHES["wavenet_cond"]
        h_in = h.float()
        got = wc.wavenet_cond(h, mel, ups, mel_w, mel_b, stride=stride)
        torch.cuda.synchronize()
    assert wc.LAUNCHES["wavenet_cond"] == before + 1
    assert got.data_ptr() == h.data_ptr()
    got = got.float()
    assert bool(got.isfinite().all())
    diff = (got - want).abs()
    assert bool((diff <= 2 * _ulp(h_in.abs() + want.abs())).all())
    assert float(diff.norm() / want.norm()) < 1e-3


@pytest.mark.card
@pytest.mark.parametrize("batch,frames,stride", SHAPES)
def test_kernel_is_exact_on_exact_data_on_card(card, batch, frames, stride):
    gen = torch.Generator().manual_seed(3 * batch + stride)
    length = frames * stride * stride - 8 * 37
    ops = _operands(gen, batch, 128, frames, length, stride, torch.bfloat16,
                    exact=True, device=card)
    with torch.inference_mode():
        want = wc.wavenet_cond_plain(*ops, stride=stride)
        got = wc.wavenet_cond(*ops, stride=stride)
    assert torch.equal(got, want)


DIFFWAVE_HP = {"hop_size": 256, "audio_num_mel_bins": 80, "T": 1000,
               "beta_0": 1e-6, "beta_T": 0.01, "noise_schedule": "", "N": 6,
               "lr": 2e-4, "seed": 0, "max_samples": 2560,
               "max_sentences": 2, "binary_data_dir": "",
               "denoiser": "wavenet", "multiband": False,
               "compute_dtype": "bfloat16"}


@pytest.mark.card
def test_launches_per_sampler_call_and_train_step_on_card(card):
    """DiffWave BASE (30 blocks) at N = 6: a replayed sampler call runs each
    block as one launch of the block kernel (``ops/wavenet_block.py``), 30
    x 6 = 180, and so none of this kernel; a training step launches
    neither."""
    from fastdiff_tpu_torch.diffusion.sampler import (constants_for_hparams,
                                                      make_sampler)
    from fastdiff_tpu_torch.ops import wavenet_block as wb
    from fastdiff_tpu_torch.training.task import FastDiffTask

    model = WaveNet(WaveNetConfig(multiband=False), seed=0,
                    device=card).eval()
    const = constants_for_hparams(DIFFWAVE_HP)
    assert const.n_steps == 6
    sampler = make_sampler(model, const)
    gen = torch.Generator(device=card).manual_seed(1)
    mel = torch.randn((1, 16, M), generator=gen, device=card) - 4.0
    length = 16 * 256
    for _ in range(2):                          # warm-up, capture
        sampler(gen, mel, length)
    before = wc.LAUNCHES["wavenet_cond"], wb.LAUNCHES["wavenet_block"]
    wav = sampler(gen, mel, length)
    torch.cuda.synchronize()
    assert wc.LAUNCHES["wavenet_cond"] - before[0] == 0
    assert wb.LAUNCHES["wavenet_block"] - before[1] == 180
    assert sampler.replay_launches(mel, length).get("wavenet_cond", 0) == 0
    assert sampler.replay_launches(mel, length)["wavenet_block"] == 180
    assert bool(wav.isfinite().all())

    task = FastDiffTask(dict(DIFFWAVE_HP), device=card)
    state = task.build_state(seed=0)
    batch = {"wavs": (0.3 * torch.randn((2, 2560, 1), generator=gen,
                                        device=card)).cpu().numpy(),
             "mels": (torch.randn((2, 10, M), generator=gen, device=card)
                      - 4.0).cpu().numpy()}
    before = wc.LAUNCHES["wavenet_cond"], wb.LAUNCHES["wavenet_block"]
    metrics = task.train_step(state, batch)
    torch.cuda.synchronize()
    assert (wc.LAUNCHES["wavenet_cond"], wb.LAUNCHES["wavenet_block"]) == \
        before
    assert math.isfinite(float(metrics["loss"]))


@pytest.mark.card
def test_wavenet_refuses_a_length_the_kernel_does_not_take_on_card(card):
    """With gradients off on a card, a length that is no multiple of 8
    raises in the wrapper rather than running the plain version."""
    model = WaveNet(WaveNetConfig(num_res_layers=1, multiband=False), seed=0,
                    device=card).eval()
    gen = torch.Generator(device=card).manual_seed(2)
    mel = torch.randn((1, 2, M), generator=gen, device=card) - 4.0
    audio = torch.randn((1, 2 * 256 - 4, 1), generator=gen, device=card)
    t = torch.ones((1, 1), device=card)
    with torch.inference_mode(), pytest.raises(ValueError,
                                               match="multiple of 8"):
        model(audio, mel, t)
