"""K8 with the NCL layout on the ``ncl`` / ``ncl_fh`` inference routes.

On the CPU: ``downpath_ncl`` (its plain version on CPU tensors) against the
module chain that ``FastDiff._down_path`` runs without it, bit for bit, at
b 1 and 2, on lengths the route fuses and on lengths it does not; the
route's gate (the trainable model, float32 compute, ``use_kernels=False``,
other widths and a length that is not ``downpath_fusable`` keep the module
chain; the NCL routes in bf16 at a fusable length call the entry, and the
forward's output is the chain's); ``pack`` keeps the NCL operands' storage
across ``load_state_dict``; the checks the CUDA path makes before its
launch; operands on which every float32 sum is
exact in any order, and on which a bias rounded to bf16 shows.

On a card (``-m card``; no JAX is imported here, so the card's machine can
run the file with ``python3 -m pytest --confcutdir=tests -c /dev/null
tests/test_torch_downpath_ncl.py -m card``): the kernel against the module
chain at b 1 x 864 frames, b 16 x 896 and b 2 x two halo units, each output
within 4 bf16 ulps of its largest value, and on the exact operands equal to
it bit for bit (and unequal to the chain with bf16 biases); a captured
graph replays the kernel, and after a reload it replays the new weights;
one replayed N = 4 sampler call launches ``downpath_ncl`` 4 times at a
fusable length and never at another, ``downpath`` (the NWC layout) never,
with K1, K2 and K3 as before.
"""

import re

import pytest
import torch
import torch.nn.functional as F

from fastdiff_tpu_torch.config import ModelConfig
from fastdiff_tpu_torch.models.fastdiff import FastDiff
from fastdiff_tpu_torch.ops import _build
from fastdiff_tpu_torch.ops import downpath_pallas as down
from fastdiff_tpu_torch.ops import nn as fnn

CFG = ModelConfig()                     # C = 32, ratios (8, 8, 4), bf16
FACTORS = tuple(CFG.upsample_ratios[::-1])
HOP = 256


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


@pytest.fixture(scope="module")
def model():
    return FastDiff(CFG, seed=0).eval()


def _chain(model, audio):
    """(skip0, skip1, skip2, x) of the module chain: the route with the
    kernels off."""
    b, length, _ = audio.shape
    model.use_kernels = False
    try:
        with torch.no_grad():
            _, x, skips, _ = model._down_path(
                audio, torch.zeros((b, length // HOP, CFG.cond_channels),
                                   device=audio.device),
                torch.ones((b, 1), device=audio.device))
    finally:
        model.use_kernels = True
    return (*skips[::-1], x)


def _entry(model, audio):
    return down.downpath_ncl(audio, model.down_first, model.down_res,
                             model.down_conv, model.down_bias, FACTORS)


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("length", [4096, 8192, 2048, 2816])
def test_cpu_entry_equals_the_module_chain(model, b, length):
    """Two and four halo units (fused by the route), one unit and a length
    that is no multiple of a unit (not fused): the plain version is the
    chain's ops, so the outputs are equal bit for bit."""
    audio = torch.randn((b, length, 1),
                        generator=torch.Generator().manual_seed(length + b))
    with torch.no_grad():
        got = _entry(model, audio)
    want = _chain(model, audio)
    for i, (g, w, rate) in enumerate(zip(got, want, (1, 4, 32, 256))):
        assert g.dtype == torch.bfloat16, i
        assert tuple(g.shape) == (b, CFG.inner_channels, length // rate), i
        assert torch.equal(g, w), i


def test_bias_pack_is_the_chain_biases(model):
    bias = down.pack_downpath_bias(model.first_audio_conv, model.downsample)
    assert bias.dtype == torch.float32 and tuple(bias.shape) == (13, 32)
    assert torch.equal(bias[0], model.first_audio_conv.bias)
    for bi, blk in enumerate(model.downsample):
        rows = bias[1 + 4 * bi:5 + 4 * bi]
        for li, cv in enumerate(blk.convs):
            assert torch.equal(rows[li], cv.bias), (bi, li)
        assert torch.equal(rows[3], blk.residual_dense.bias), bi
    assert torch.equal(model.down_bias, bias)


def _spy(monkeypatch):
    calls = []
    entry = down.downpath_ncl

    def spy(*args):
        calls.append(args[0].shape)
        return entry(*args)

    monkeypatch.setattr(down, "downpath_ncl", spy)
    return calls


def _forward(m, length, b=1, seed=0):
    gen = torch.Generator().manual_seed(seed)
    audio = torch.randn((b, length, 1), generator=gen)
    mel = torch.randn((b, length // HOP, CFG.cond_channels), generator=gen)
    with torch.no_grad():
        return m(audio, mel, torch.full((b, 1), 7.0))


@pytest.mark.parametrize("route", ["ncl", "ncl_fh"])
def test_route_calls_the_entry_at_a_fusable_length(route, monkeypatch):
    """bf16, C = 32, factors (4, 8, 8), 16 frames: the entry runs once a
    forward, and the forward is the module chain's bit for bit."""
    m = FastDiff(CFG, seed=1, infer_route=route).eval()
    calls = _spy(monkeypatch)
    got = _forward(m, 16 * HOP)
    assert calls == [(1, 16 * HOP, 1)]
    monkeypatch.setattr(down, "downpath_fusable", lambda *a: False)
    want = _forward(m, 16 * HOP)
    assert len(calls) == 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["train", "float32", "no kernels",
                                  "length 8 frames", "length 100 frames",
                                  "16 channels", "nwc"])
def test_route_keeps_the_module_chain(case, monkeypatch):
    """Every other case keeps the chain (the entry is never called): the
    trainable model, float32 compute, ``use_kernels=False``, one halo unit
    and a length that is no multiple of it, other widths, the NWC route."""
    frames = {"length 8 frames": 8, "length 100 frames": 100}.get(case, 16)
    cfg = CFG
    kw = {}
    if case == "float32":
        cfg = ModelConfig(compute_dtype="float32")
    elif case == "16 channels":
        cfg = ModelConfig(inner_channels=16)
    elif case == "train":
        kw = dict(train_route="plain")
    elif case == "nwc":
        kw = dict(infer_route="nwc")
    m = FastDiff(cfg, seed=2, **kw).eval()
    if case == "no kernels":
        m.use_kernels = False
    calls = _spy(monkeypatch)
    out = _forward(m, frames * HOP)
    assert calls == []
    assert out.shape == (1, frames * HOP, 1)
    if case in ("train", "float32", "16 channels", "nwc"):
        assert not hasattr(m, "down_bias")


def test_pack_keeps_the_ncl_operands_storage_across_a_reload():
    """``load_state_dict`` repacks into the buffers ``pack`` made, so a
    graph captured before it replays the new weights."""
    m = FastDiff(CFG, seed=0).eval()
    names = ("down_first", "down_res", "down_conv", "down_bias")
    ptrs = {n: getattr(m, n).data_ptr() for n in names}
    other = FastDiff(CFG, seed=3).eval()
    m.load_state_dict(other.state_dict())
    for n in names:
        assert getattr(m, n).data_ptr() == ptrs[n], n
        assert torch.equal(getattr(m, n), getattr(other, n)), n
    assert not torch.equal(m.down_bias,
                           FastDiff(CFG, seed=0).down_bias)


def _ops(b, length, *, c=32, bias_dtype=torch.float32, bias_rows=13):
    gen = torch.Generator().manual_seed(5)
    audio = torch.randn((b, length, 1), generator=gen)
    first = torch.randn((8, c), generator=gen).to(torch.bfloat16)
    res = torch.randn((3, c + 1, c), generator=gen).to(torch.bfloat16)
    conv = torch.randn((3, 3, 3 * c + 1, c),
                       generator=gen).to(torch.bfloat16)
    bias = torch.randn((bias_rows, c), generator=gen).to(bias_dtype)
    return audio, first, res, conv, bias


FAULTS = {"length 4096 + 256": (dict(length=4096 + 256), "multiple of 2048"),
          "bias bf16": (dict(bias_dtype=torch.bfloat16), "bias must be"),
          "bias rows 12": (dict(bias_rows=12), "bias must be"),
          "16 channels": (dict(c=16), "built for C=32")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_cuda_checks_refuse_before_launching(fault, monkeypatch):
    """What ``downpath_ncl`` checks on a CUDA tensor, run on CPU operands:
    each fault raises and nothing reaches the kernel library."""
    kw, words = FAULTS[fault]
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("launched"))
    kw = dict(kw)
    length = kw.pop("length", 4096)
    with pytest.raises(ValueError, match=re.escape(words)):
        down.check_ncl_operands(*_ops(2, length, **kw), FACTORS)
    down.check_ncl_operands(*_ops(2, 4096), FACTORS)
    meta = torch.zeros((1, 4096, 1), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        down.downpath_ncl(meta, *_ops(1, 4096)[1:], FACTORS)


def _exact_ops(b, length, seed=0):
    """Operands on which every float32 sum of the down path is exact in
    any order: audio on a 2^-4 grid in [0, 1], weights m 2^-8 with m in
    0..3 (bf16), biases in [1, 2) on a 2^-10 grid (11 significant bits,
    float32; the packs' bias rows hold their bf16 rounding, as ``pack``
    writes them). Nothing is negative, so leaky ReLU passes its input and
    every conv output is at least 1, its bf16 value a multiple of 2^-7;
    every product is then a multiple of 2^-15, and no sum reaches 2^9 (the
    largest is below 70), inside float32's 24 bits."""
    gen = torch.Generator().manual_seed(seed)
    c = CFG.inner_channels

    def weights(rows, bias_row):
        w = torch.randint(0, 4, (rows, c), generator=gen) * 2.0 ** -8
        return torch.cat([w, bias_row[None]])

    bias = 1 + torch.randint(0, 1024, (13, c), generator=gen) / 1024.0
    audio = torch.randint(0, 17, (b, length, 1), generator=gen) / 16.0
    first = weights(7, bias[0])
    res = torch.stack([weights(c, bias[4 + 4 * i]) for i in range(3)])
    conv = torch.stack([torch.stack([weights(3 * c, bias[1 + 4 * i + li])
                                     for li in range(3)])
                        for i in range(3)])
    bf16 = torch.bfloat16
    return audio, first.to(bf16), res.to(bf16), conv.to(bf16), bias


def _chain64(audio, first, res, conv, bias):
    """``downpath_ncl_plain``'s cast points with every conv summed in
    float64."""
    def conv1d(w_aug, taps, b, x, dilation=1):
        w = down._unpack_conv(w_aug, taps).double()
        return F.conv1d(x.double(), w, b.double(), dilation=dilation,
                        padding=dilation * (taps // 2)).to(torch.bfloat16)

    n, length, _ = audio.shape
    x = conv1d(first, 7, bias[0],
               audio.to(torch.bfloat16).reshape(n, 1, length))
    outs = [x]
    for bi, f in enumerate(FACTORS):
        rows = bias[1 + 4 * bi:]
        x = x[..., ::f]
        residual = conv1d(res[bi], 1, rows[3], x)
        for li in range(3):
            x = conv1d(conv[bi, li], 3, rows[li], fnn.leaky_relu(x, 0.2),
                       dilation=2 ** li)
        x = x + residual
        outs.append(x)
    return tuple(outs)


def _planted(ops):
    """The same operands with each bias rounded to bf16: the NWC layout's
    bias rows, which the NCL layout must not add."""
    *rest, bias = ops
    return (*rest, bias.to(torch.bfloat16).float())


@pytest.mark.parametrize("b,length", [(2, 4096), (1, 8192)])
def test_exact_operands_sum_exactly(b, length):
    """The plain version in float32 equals the same cast points summed in
    float64, and every output lies in [1, 2^9): the sums are exact."""
    ops = _exact_ops(b, length, seed=length + b)
    got = down.downpath_ncl_plain(*ops, FACTORS)
    want = _chain64(*ops)
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), i
        assert 1 <= float(g.float().min()) and float(g.float().max()) < 512


@pytest.mark.parametrize("b,length", [(2, 4096), (1, 8192)])
def test_a_bf16_bias_shows_on_exact_operands(b, length):
    """Biases rounded to bf16 change every output on these operands, so an
    equality check on them tells a float32 bias from a bf16 one."""
    ops = _exact_ops(b, length, seed=length + b)
    assert not torch.equal(ops[-1], _planted(ops)[-1])
    got = down.downpath_ncl_plain(*ops, FACTORS)
    planted = down.downpath_ncl_plain(*_planted(ops), FACTORS)
    for i, (g, p) in enumerate(zip(got, planted)):
        assert not torch.equal(g, p), i


# card: the 10-s utterance, the offline cell's longest call, two halo units
CARD_SHAPES = [(1, 864 * HOP), (16, 896 * HOP), (2, 4096)]


def _ulp_bound(want):
    """4 bf16 ulps of the output's largest value (phase 14's bound)."""
    return 2.0 ** -5 * float(want.float().abs().max())


@pytest.mark.card
@pytest.mark.parametrize("b,length", CARD_SHAPES)
def test_kernel_matches_the_module_chain_on_card(card, b, length):
    """The kernel sums each conv in another order than cuDNN, so a value
    near a bf16 step may round the other way: each output within 4 bf16
    ulps of its largest value (K8's bound), and one count."""
    m = FastDiff(CFG, seed=0, device=card).eval()
    audio = torch.randn((b, length, 1), device=card,
                        generator=torch.Generator(device=card)
                        .manual_seed(b))
    before = dict(down.LAUNCHES)
    with torch.inference_mode():
        got = _entry(m, audio)
        torch.cuda.synchronize()
    assert down.LAUNCHES == dict(before,
                                 downpath_ncl=before["downpath_ncl"] + 1)
    want = _chain(m, audio)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, i
        err = float((g.float() - w.float()).abs().max())
        assert err <= _ulp_bound(w), (i, err, _ulp_bound(w))


@pytest.mark.card
@pytest.mark.parametrize("b,length", CARD_SHAPES)
def test_kernel_is_exact_on_exact_operands_on_card(card, b, length):
    """On operands whose every float32 sum is exact, the kernel equals the
    plain version (run on the CPU) bit for bit, and differs from the plain
    version with bf16 biases: it adds the float32 biases."""
    ops = _exact_ops(b, length, seed=b)
    with torch.inference_mode():
        got = down.downpath_ncl(*(t.to(card) for t in ops), FACTORS)
        torch.cuda.synchronize()
    want = down.downpath_ncl_plain(*ops, FACTORS)
    planted = down.downpath_ncl_plain(*_planted(ops), FACTORS)
    for i, (g, w, p) in enumerate(zip(got, want, planted)):
        g = g.cpu()
        assert torch.equal(g, w), (i, int((g != w).sum()))
        assert not torch.equal(g, p), i


@pytest.mark.card
def test_graph_replays_the_kernel_and_a_reload_on_card(card):
    """Captured once; a replay equals an eager call; after
    ``load_state_dict`` of other weights (same storage) the replay equals
    an eager call with the new weights."""
    m = FastDiff(CFG, seed=0, device=card).eval()
    audio = torch.randn((2, 4096, 1), device=card,
                        generator=torch.Generator(device=card).manual_seed(9))
    with torch.inference_mode():
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            _entry(m, audio)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = _entry(m, audio)
        graph.replay()
        eager = _entry(m, audio)
        torch.cuda.synchronize()
        assert all(torch.equal(o, e) for o, e in zip(out, eager))
        first = [o.clone() for o in out]
        m.load_state_dict(FastDiff(CFG, seed=4, device=card).state_dict())
        graph.replay()
        eager = _entry(m, audio)
        torch.cuda.synchronize()
    assert all(torch.equal(o, e) for o, e in zip(out, eager))
    assert not any(torch.equal(o, f) for o, f in zip(out, first))


@pytest.mark.card
@pytest.mark.parametrize("frames,per_call", [(128, 4), (100, 0)])
def test_launches_per_replayed_sampler_call_on_card(card, frames, per_call):
    """N = 4: a replayed call launches ``downpath_ncl`` once a step at a
    fusable length (128 frames, one bucket) and never at 100 frames, the
    NWC layout's ``downpath`` never; K3 12, K1 8 and K2 4 either way."""
    from fastdiff_tpu_torch.diffusion.sampler import (constants_for_hparams,
                                                      make_sampler)
    from fastdiff_tpu_torch.ops import lvc_block_ncl, lvc_head

    m = FastDiff(CFG, seed=0, device=card).eval()
    sampler = make_sampler(m, constants_for_hparams({"N": 4}))
    gen = torch.Generator(device=card).manual_seed(1)
    mel = torch.randn((1, frames, CFG.cond_channels), generator=gen,
                      device=card) - 4.0
    length = frames * HOP
    for _ in range(2):                          # warm-up, capture
        sampler(gen, mel, length)
    counters = (down.LAUNCHES, lvc_head.LAUNCHES, lvc_block_ncl.LAUNCHES)
    before = {k: v for c in counters for k, v in c.items()}
    wav = sampler(gen, mel, length)
    torch.cuda.synchronize()
    rise = {k: v - before[k] for c in counters for k, v in c.items()}
    assert (rise["downpath_ncl"], rise["downpath"]) == (per_call, 0)
    assert (rise["taug_head"], rise["lvc_block_ncl"],
            rise["lvc_block_ncl_final"]) == (12, 8, 4)
    replayed = sampler.replay_launches(mel, length)
    assert (replayed.get("downpath_ncl", 0),
            replayed.get("downpath", 0)) == (per_call, 0)
    assert bool(wav.isfinite().all())
