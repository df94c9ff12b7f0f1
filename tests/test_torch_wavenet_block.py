"""DiffWave's whole residual block (``ops/wavenet_block.py``).

On the CPU: the plain version against the module chain ``models/wavenet.py``
ran before it had the op (bit for bit), for block 0 (bf16 x, no skip sum
yet), a middle block and the last one, at every dilation 1-512 and at
lengths where t - d and t + d leave both ends (L < d too); a Python model
of the kernel (``csrc/wavenet_block.cu``: its window rows, one f32 sum for
the dilated conv and the mel projection, the gate in f32) against the plain
version; ``WaveNet``'s route by widths, dtype and gradient mode (the
plain block, with the plain conditioning, at every width the kernel
declines); the wrapper's geometry, shared memory and C entry against the
source; the refusals of the CUDA wrapper, which come before any launch.

On a card (``-m card``; no JAX is imported here, so the card's machine can
run the file with ``python3 -m pytest --confcutdir=tests -c /dev/null
tests/test_torch_wavenet_block.py -m card``): the kernel against the plain
version at the DiffWave cell's b 16 x 896 frames and at b 1 x 864, every
dilation, and against float64 at b 1 x 864; a graph replay against an eager
launch; the launches of one replayed DiffWave BASE sampler call and of a
training step; ``WaveNet`` refusing a length the kernel does not take.
"""

import math
import re
import sys

import pytest
import torch
import torch.nn.functional as F

from fastdiff_tpu_torch.models.wavenet import WaveNet, WaveNetConfig
from fastdiff_tpu_torch.ops import _build
from fastdiff_tpu_torch.ops import wavenet_block as wb
from fastdiff_tpu_torch.ops import wavenet_cond as wc

M, C = 80, 64
BF = torch.bfloat16
DILATIONS = [2 ** k for k in range(10)]


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


def _bf(x):
    return x.to(BF).float()


def _weights(gen, stride, device="cpu"):
    """One block's f32 weights at DiffWave BASE's widths, drawn as the seed
    model draws them (kaiming-normal convs, their fan-in's uniform biases)."""
    def normal(shape, fan_in):
        return torch.randn(shape, generator=gen) * math.sqrt(2.0 / fan_in)

    def bias(n, fan_in):
        return (torch.rand((n,), generator=gen) * 2 - 1) * fan_in ** -0.5

    w = wb.BlockWeights(
        normal((2 * C, C, 3), 3 * C), bias(2 * C, 3 * C),
        [(normal((1, 1, 3, 2 * stride), 6 * stride),
          0.1 * torch.randn((1,), generator=gen)) for _ in range(2)],
        normal((2 * C, M, 1), M), bias(2 * C, M),
        normal((C, C, 1), C), bias(C, C), normal((C, C, 1), C), bias(C, C))
    return wb.BlockWeights(*[
        [(a.to(device), b.to(device)) for a, b in t] if isinstance(t, list)
        else t.to(device) for t in w])


def _operands(gen, batch, frames, length, stride, kind, device="cpu"):
    """(x, skip_sum, part_t, mel): block 0 ("first": bf16 x, no skip sum)
    or a later block (f32 x of unit scale, a running skip sum)."""
    mel = (torch.randn((batch, frames, M), generator=gen) - 4.0).to(BF)
    part_t = torch.randn((batch, C), generator=gen)
    if kind == "first":
        x = torch.relu(torch.randn((batch, C, length), generator=gen)).to(BF)
        skip = None
    else:
        x = torch.randn((batch, C, length), generator=gen)
        skip = 3.0 * torch.randn((batch, C, length), generator=gen)
    return tuple(t if t is None else t.to(device).contiguous()
                 for t in (x, skip, part_t, mel))


def _chain(x, skip_sum, part_t, mel, w, dilation, stride):
    """The module chain as ``WaveNet.forward`` ran it before the op: the
    step part added in x's dtype, each conv on f32 copies of bf16-rounded
    operands with its f32 bias and rounded back, the gate in bf16, x in f32
    from the residual on, the skip sum from zeros."""
    def conv(wt, b, h, dil=1):
        pad = dil * ((wt.shape[-1] - 1) // 2)
        return F.conv1d(h.to(BF).float(), wt.to(BF).float(), b.float(),
                        padding=pad, dilation=dil).to(BF)

    if skip_sum is None:
        skip_sum = torch.zeros(x.shape[0], C, x.shape[-1])
    h = x + part_t[:, :, None].to(x.dtype)
    h = conv(w.w_dil, w.b_dil, h, dilation)
    h = wc.wavenet_cond_plain(h, mel, w.ups, w.mel_w, w.mel_b, stride=stride)
    out = torch.tanh(h[:, :C]) * torch.sigmoid(h[:, C:])
    res = conv(w.w_res, w.b_res, out)
    x = (x + res).float() * float(torch.tensor(math.sqrt(0.5)))
    return x, skip_sum + conv(w.w_skip, w.b_skip, out)


# (stride, frames, length): t - d and t + d leave both ends at every
# dilation; at 2 x 256 - 8 = 504 samples L < 512
CASES = [(16, 2, 2 * 256 - 8), (8, 9, 9 * 64 - 24)]
KINDS = ["first", "middle", "last"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dilation", DILATIONS)
@pytest.mark.parametrize("stride,frames,length", CASES)
def test_plain_equals_the_module_chain(stride, frames, length, dilation,
                                       kind):
    gen = torch.Generator().manual_seed(dilation + stride)
    w = _weights(gen, stride)
    x, skip, part_t, mel = _operands(gen, 2, frames, length, stride,
                                     "first" if kind == "first" else "later")
    want_x, want_skip = _chain(x, skip, part_t, mel, w, dilation, stride)
    skip_in = None if skip is None else skip.clone()
    got_x, got_skip = wb.wavenet_block(
        x, skip_in, part_t, mel, w, dilation=dilation, stride=stride,
        want_x=kind != "last")
    assert got_skip.dtype == torch.float32
    assert torch.equal(got_skip, want_skip)
    if kind == "last":
        assert got_x is None
    else:
        assert got_x.dtype == torch.float32 and torch.equal(got_x, want_x)


def _kernel_model(x, skip_sum, part_t, mel, w, dilation, stride):
    """``csrc/wavenet_block.cu`` in Python, tile by tile: the window of a =
    bf16(x + t_n) gathered at ``window``'s row positions (zero outside [0,
    L)), each tap read from its first row; [W_dil | W_mel] against the
    stacked operand in one f32 sum with b_dil + b_mel; the gate in f32,
    rounded once; r and s rounded after their biases; x' and the skip sum
    in f32. The conditioning is the plain version's (the kernel's stages
    are modelled against it in ``test_torch_wavenet_cond.py``)."""
    batch, _, length = x.shape
    xbf = x.dtype == BF
    pt = _bf(part_t) if xbf else part_t.float()
    cond = wc.wavenet_cond_plain(torch.zeros(batch, M, length, dtype=BF),
                                 mel, [(a, b) for a, b in w.ups],
                                 torch.eye(M)[:, :, None], torch.zeros(M),
                                 stride=stride).float()
    wa = _bf(torch.cat([w.w_dil[:, :, k] for k in range(3)]
                       + [w.mel_w[:, :, 0]], dim=1))        # (128, 272)
    wo = _bf(torch.cat([w.w_res[:, :, 0], w.w_skip[:, :, 0]]))
    b1 = w.b_dil + w.mel_b
    b2 = torch.cat([w.b_res, w.b_skip])
    rows, taps, offs = wb.window(dilation)
    offs = torch.tensor(offs)
    x_new = torch.empty(batch, C, length)
    skip_new = torch.empty(batch, C, length)
    xf = x.float()
    for j0 in range(0, length, wb.TILE):
        n = min(wb.TILE, length - j0)
        pos = j0 + offs
        inside = (pos >= 0) & (pos < length)
        a = torch.zeros(batch, rows, C)
        a[:, inside] = _bf(xf[:, :, pos[inside]].transpose(1, 2)
                           + pt[:, None, :])
        op = torch.cat([a[:, taps[k]:taps[k] + n] for k in range(3)]
                       + [cond[:, :, j0:j0 + n].transpose(1, 2)], dim=2)
        z = op @ wa.T + b1
        out = _bf(torch.tanh(z[..., :C]) * torch.sigmoid(z[..., C:]))
        rs = _bf(out @ wo.T + b2).transpose(1, 2)           # (B, 128, n)
        r, s = rs[:, :C], rs[:, C:]
        xt = xf[:, :, j0:j0 + n]
        x_new[:, :, j0:j0 + n] = (_bf(xt + r) if xbf else xt + r) \
            * wb.SQRT_HALF
        skip_new[:, :, j0:j0 + n] = s if skip_sum is None \
            else skip_sum[:, :, j0:j0 + n] + s
    return x_new, skip_new


def _update_errors(got, want, x, skip_sum):
    """Relative L2 gaps of x' and of the skip sum, each over the size of
    what the block added (the residual, the skip output)."""
    gx, gs = got
    wx, ws = want
    base_x = x.float() * wb.SQRT_HALF
    base_s = 0 if skip_sum is None else skip_sum
    return (float((gx - wx).norm() / (wx - base_x).norm()),
            float((gs - ws).norm() / (ws - base_s).norm()))


@pytest.mark.parametrize("dilation", [1, 8, 64, 512])
@pytest.mark.parametrize("kind", ["first", "later"])
def test_kernel_model_is_near_the_plain_version(kind, dilation):
    """The model rounds where the kernel rounds: the dilated conv and the
    projection in one f32 sum, the gate once. It differs from the plain
    chain only where a value falls near a bf16 step: a few parts in a
    thousand of each update, far below the rounding of bf16 operands."""
    stride, frames, length = CASES[0]
    gen = torch.Generator().manual_seed(40 + dilation)
    w = _weights(gen, stride)
    x, skip, part_t, mel = _operands(gen, 2, frames, length, stride, kind)
    got = _kernel_model(x, skip, part_t, mel, w, dilation, stride)
    want = wb.wavenet_block_plain(x, None if skip is None else skip.clone(),
                                  part_t, mel, w, dilation=dilation,
                                  stride=stride)
    ex, es = _update_errors(got, want, x, skip)
    assert ex < 1e-2 and es < 1e-2, (ex, es)


@pytest.mark.parametrize("dilation", list(range(1, 70)) + [72, 96, 128,
                                                            200, 256, 512])
def test_window_rows_hold_every_tap(dilation):
    """Each tap's TILE rows, from its first row, are the samples t + (k - 1)
    d; the window fits its shared memory; every 8-row chunk is 8
    consecutive samples starting at a multiple of 8 (16-byte loads)."""
    if not wb.supports_dilation(dilation):
        with pytest.raises(ValueError, match="dilation"):
            wb.check_operands(*_small_operands(), dilation=dilation,
                              stride=16)
        return
    rows, taps, offs = wb.window(dilation)
    assert rows <= wb.XROWS and rows % 8 == 0 and len(offs) == rows
    for k, first in enumerate(taps):
        assert offs[first:first + wb.TILE] == tuple(
            n + (k - 1) * dilation for n in range(wb.TILE))
    for r in range(0, rows, 8):
        assert offs[r] % 8 == 0
        assert offs[r:r + 8] == tuple(range(offs[r], offs[r] + 8))


def _window_index(row, channel):
    """Where the kernel keeps (row, channel) of the window: 16-byte column
    chunks XOR-swizzled by row / 8."""
    return (row * wb.XROW + (((channel >> 3) ^ ((row >> 3) & 7)) << 3)
            + (channel & 7))


def test_window_swizzle_reads_what_it_stores():
    """The stores of step 1 and ldmatrix's reads of GEMM 1 use one mapping
    (the source's two expressions), a bijection onto the window's unpadded
    columns; each store instruction (lanes: chunk pq, pair cq) and each
    8-row ldmatrix phase at an aligned row hit 32 distinct banks."""
    src = _source()
    assert ("(((cpv[h] >> 2) ^ (chunk[h] & 7)) << 3) + 2 * (cpv[h] & 3)"
            in " ".join(src.split()))
    assert "(((2 * kc + hi) ^ s0) << 3)" in src
    assert "const int s0 = (ra >> 3) & 7, s1 = (rb2 >> 3) & 7" in src
    seen = set()
    for row in range(wb.XROWS):
        for ch in range(C):
            i = _window_index(row, ch)
            assert i % wb.XROW < C
            seen.add(i)
        # ldmatrix: 8 channels from the chunk's first address
        for kc in range(C // 8):
            first = _window_index(row, 8 * kc)
            assert [first + e for e in range(8)] == [
                _window_index(row, 8 * kc + e) for e in range(8)]
    assert len(seen) == wb.XROWS * C
    for k in range(8):                  # row within the chunk
        for cb in range(8):             # the warp unit's block of 4 pairs
            banks = {(_window_index(8 * pq + k, 2 * (4 * cb + cq)) // 2) % 32
                     for pq in range(8) for cq in range(4)}
            assert len(banks) == 32
    for r0 in range(0, wb.XROWS, 8):
        for kc in range(C // 8):
            banks = {(_window_index(r0 + e, 8 * kc) // 2 + w) % 32
                     for e in range(8) for w in range(4)}
            assert len(banks) == 32


def _small_wavenet(res=C, skip=C, multiband=False, dtype="bfloat16",
                   layers=3):
    cfg = WaveNetConfig(res_channels=res, skip_channels=skip,
                        num_res_layers=layers, noise_scale_embed_dim_in=16,
                        noise_scale_embed_dim_mid=32,
                        noise_scale_embed_dim_out=32, multiband=multiband,
                        compute_dtype=dtype)
    model = WaveNet(cfg, seed=0)
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():     # a non-zero output conv (seed weights zero it)
        model.out_conv.weight.normal_(generator=gen)
    return model


@pytest.mark.parametrize("multiband", [False, True])
def test_no_grad_route_runs_the_block_op(multiband, monkeypatch):
    """DiffWave BASE's widths with gradients off: one ``wavenet_block`` a
    block (the last without x'), the same output as the route with
    gradients on, which runs the plain version."""
    model = _small_wavenet(multiband=multiband)
    assert model.block_kernel
    s = model.cfg.upsample_strides[0]
    frames = 3
    gen = torch.Generator().manual_seed(6)
    audio = torch.randn((2, frames * s * s, 1), generator=gen)
    mel = torch.randn((2, frames, M), generator=gen) - 4.0
    t = torch.tensor([[3.0], [17.5]])
    calls, plain = [], []
    op, plain_op = wb.wavenet_block, wb.wavenet_block_plain
    monkeypatch.setattr(wb, "wavenet_block", lambda *a, **k: calls.append(
        k["want_x"]) or op(*a, **k))
    monkeypatch.setattr(wb, "wavenet_block_plain", lambda *a, **k: plain.append(
        1) or plain_op(*a, **k))
    with_grad = model(audio, mel, t)
    assert with_grad.requires_grad and not calls
    assert len(plain) == model.cfg.num_res_layers
    with torch.no_grad():
        without = model(audio, mel, t)
    assert calls == [True] * (model.cfg.num_res_layers - 1) + [False]
    assert torch.equal(without, with_grad.detach())
    assert float(without.abs().max()) > 0


def test_route_by_widths_and_dtype():
    assert wb.supports(64, 64, 80, 16, BF)               # DiffWave BASE
    assert wb.supports(64, 64, 80, 8, BF)                # multiband
    for args in ((32, 64, 80, 16, BF), (64, 32, 80, 16, BF),
                 (128, 128, 80, 16, BF), (64, 64, 64, 16, BF),
                 (64, 64, 80, 4, BF), (64, 64, 80, 16, torch.float32)):
        assert not wb.supports(*args), args
    assert WaveNet(WaveNetConfig(num_res_layers=1), seed=0).block_kernel
    assert not _small_wavenet(dtype="float32").block_kernel
    assert not _small_wavenet(res=32, skip=32).block_kernel
    assert wb.fits_length(896 * 256, 896, 16)
    assert wb.fits_length(8, 1, 16)
    assert not wb.fits_length(896 * 256 + 8, 896, 16)
    assert not wb.fits_length(100, 1, 16)
    assert not wb.fits_length(0, 1, 16)
    for d in DILATIONS + [1024, 2048, 3, 48]:
        assert wb.supports_dilation(d), d
    for d in (0, 65, 100, 130):
        assert not wb.supports_dilation(d), d


# widths the block kernel declines: (residual, skip, mel bins, dtype)
DECLINED = {"residual 32": (32, C, M, "bfloat16"),
            "residual 128": (128, C, M, "bfloat16"),
            "skip 32": (C, 32, M, "bfloat16"),
            "64 mel bins": (C, C, 64, "bfloat16"),
            "float32": (C, C, M, "float32")}


@pytest.mark.parametrize("widths", list(DECLINED))
def test_declined_widths_run_the_plain_block(widths, monkeypatch):
    """With gradients off, at widths the block kernel declines, each block
    runs ``wavenet_block_plain``, whose conditioning is the plain version
    called by it directly; ``wavenet_block`` never runs. The output is the
    route's with gradients on."""
    res, skip, n_mels, dtype = DECLINED[widths]
    cfg = WaveNetConfig(res_channels=res, skip_channels=skip,
                        num_res_layers=3, noise_scale_embed_dim_in=16,
                        noise_scale_embed_dim_mid=32,
                        noise_scale_embed_dim_out=32, multiband=False,
                        cond_channels=n_mels, compute_dtype=dtype)
    model = WaveNet(cfg, seed=0)
    assert not model.block_kernel
    gen = torch.Generator().manual_seed(8)
    with torch.no_grad():     # a non-zero output conv (seed weights zero it)
        model.out_conv.weight.normal_(generator=gen)
    audio = torch.randn((2, 3 * 256, 1), generator=gen)
    mel = torch.randn((2, 3, n_mels), generator=gen) - 4.0
    t = torch.tensor([[3.0], [17.5]])
    blocks, conds = [], []
    plain_op, cond_op = wb.wavenet_block_plain, wc.wavenet_cond_plain
    monkeypatch.setattr(wb, "wavenet_block", lambda *a, **k: pytest.fail(
        "the block op ran"))
    monkeypatch.setattr(wb, "wavenet_block_plain", lambda *a, **k: blocks.append(
        1) or plain_op(*a, **k))

    def cond(*a, **k):
        conds.append(sys._getframe(1).f_code.co_name)
        return cond_op(*a, **k)

    monkeypatch.setattr(wc, "wavenet_cond_plain", cond)
    with torch.no_grad():
        without = model(audio, mel, t)
    assert len(blocks) == cfg.num_res_layers
    assert conds == ["wavenet_block_plain"] * cfg.num_res_layers
    assert torch.equal(without, model(audio, mel, t).detach())
    assert float(without.abs().max()) > 0


def _source() -> str:
    return (_build.CSRC / "wavenet_block.cu").read_text()


def test_python_geometry_matches_the_source():
    src = _source()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("C") == wb.C and const("CS") == wb.CS
    assert const("TILE") == wb.TILE and const("GT") == wb.GT
    assert const("GROUPS") == wb.GROUPS
    assert re.search(r"constexpr int CH2 = 2 \* C;", src)
    assert re.search(r"constexpr int NOUT = C \+ CS;", src)
    assert re.search(r"constexpr int THREADS = GROUPS \* GT;", src)
    for name, expr in (("KX", r"3 \* C"), ("K1", r"KX \+ NM"),
                       ("WROW", r"K1 \+ 8"), ("W2ROW", r"C \+ 8"),
                       ("XROW", r"C \+ 8"), ("XROWS", r"3 \* TILE"),
                       ("CROW", r"NM \+ 8"), ("OROW", r"C \+ 8"),
                       ("SROW", r"TILE \+ 8")):
        assert re.search(rf"constexpr int {name} = {expr};", src), name
    assert wb.K1 == 272 and wb.WROW == 280 and wb.XROWS == 192
    assert wb.CROW == 88 and wb.UROW == 82 and wb.N_MELS == 80
    header = (_build.CSRC / "wavenet_cond.cuh").read_text()
    assert re.search(r"constexpr int NM = 80;", header)
    assert re.search(r"constexpr int UROW = NM \+ 2;", header)
    assert re.search(r"static constexpr int NP = TILE / S \+ 2;", header)
    assert re.search(r"static constexpr int NF = \(NP - 1\) / S \+ 3;",
                     header)

    def body(name):
        text = re.search(rf"static constexpr int {name} =\s*([^;]*);",
                         src).group(1)
        return " ".join(text.split())

    assert body("XS") == "2 * XROWS * XROW"
    assert body("CSB") == "2 * TILE * CROW"
    assert body("GROUP") == "(XS + CSB + 4 * UROW * (NP + NF) + 127) / 128 * 128"
    assert body("WA") == "2 * CH2 * WROW"
    assert body("WO") == "2 * NOUT * W2ROW"
    assert body("BYTES") == ("WA + WO + GROUPS * GROUP + "
                             "4 * (2 * 3 * 2 * S + CH2 + NOUT) + 16")
    # the window's rows and taps are window()'s (its test checks them)
    for line in ("g.contiguous = d <= TILE;",
                 "g.e = g.contiguous ? (d + 7) / 8 * 8 : 0;",
                 "g.nrows = g.contiguous ? TILE + 2 * g.e : 3 * TILE;",
                 "g.tap[0] = g.contiguous ? g.e - d : 0;",
                 "g.tap[1] = g.contiguous ? g.e : TILE;",
                 "g.tap[2] = g.contiguous ? g.e + d : 2 * TILE;"):
        assert line in src, line
    # the C entry's dilation rule is supports_dilation's
    assert "(dilation > TILE && dilation % 8)" in src
    for s in wb.STRIDES:
        assert re.search(rf"stride == {s}\)\s*return launch<{s}>", src)


@pytest.mark.parametrize("stride", wb.STRIDES)
def test_shared_memory_grid_and_entry(stride):
    np_, nf = wb.stage1_rows(stride), wb.mel_frames(stride)
    raw = 2 * wb.XROWS * wb.XROW + 2 * wb.TILE * wb.CROW + 4 * wb.UROW * (
        np_ + nf)
    assert wb.group_bytes(stride) == -(-raw // 128) * 128
    assert wb.smem_bytes(stride) == (
        2 * 128 * wb.WROW + 2 * 128 * wb.W2ROW
        + wb.GROUPS * wb.group_bytes(stride)
        + 4 * (12 * stride + 256) + 16)
    # one block an SM; r / s and the gate fit where they reuse
    assert wb.smem_bytes(stride) + wb.SMEM_RESERVED <= wb.SMEM_MAX_BLOCK
    assert 2 * 128 * wb.SROW <= 2 * wb.XROWS * wb.XROW
    assert 2 * wb.TILE * wb.OROW <= 2 * wb.TILE * wb.CROW
    assert wb.launch_grid(16, 896 * 256, 132) == 132
    assert wb.launch_grid(1, 64, 132) == 1
    assert wb.launch_grid(1, 7 * wb.TILE, 132) == 3
    arity = re.search(r'extern "C" int wavenet_block_launch\(([^)]*)\)',
                      _source()).group(1).count(",") + 1
    assert arity == len(_build.SIGNATURES["wavenet_block_launch"]) == 30


def _small_operands():
    gen = torch.Generator().manual_seed(3)
    w = _weights(gen, 16)
    x, skip, part_t, mel = _operands(gen, 1, 1, 256, 16, "later")
    return x, skip, part_t, mel, w


def _bad(name):
    """The operands of ``_small_operands`` with one fault, and the words
    the refusal names."""
    x, skip, part_t, mel, w = _small_operands()
    kw = dict(dilation=4, stride=16)
    if name == "mel f32":
        return (x, skip, part_t, mel.float(), w), kw, "bf16"
    if name == "x f16":
        return (x.half(), skip, part_t, mel, w), kw, "f32 or bf16"
    if name == "32 channels":
        return (x[:, :32].contiguous(), skip, part_t, mel, w), kw, \
            "no kernel for 32"
    if name == "64 bins":
        return (x, skip, part_t, mel[..., :64].contiguous(), w), kw, \
            "64 mel bins"
    if name == "stride 4":
        return (x, skip, part_t, mel, w), dict(kw, stride=4), "stride 4"
    if name == "dilation 100":
        return (x, skip, part_t, mel, w), dict(kw, dilation=100), \
            "dilation 100"
    if name == "length 252":
        return (x[..., :252].contiguous(), skip[..., :252].contiguous(),
                part_t, mel, w), kw, "multiple of 8"
    if name == "length past the mel":
        return (torch.cat([x, x[..., :8]], -1), torch.cat([skip, skip[..., :8]],
                                                          -1),
                part_t, mel, w), kw, "at most 1 x 16"
    if name == "w_dil shape":
        return (x, skip, part_t, mel, w._replace(w_dil=w.w_dil[:, :, :1]
                                                 .contiguous())), kw, "w_dil"
    if name == "part_t f16":
        return (x, skip, part_t.half(), mel, w), kw, "part_t"
    if name == "skip_sum bf16":
        return (x, skip.to(BF), part_t, mel, w), kw, "skip_sum"
    if name == "x strided":
        return (x.transpose(1, 2).contiguous().transpose(1, 2), skip,
                part_t, mel, w), kw, "x must be contiguous"
    raise KeyError(name)


FAULTS = ["mel f32", "x f16", "32 channels", "64 bins", "stride 4",
          "dilation 100", "length 252", "length past the mel",
          "w_dil shape", "part_t f16", "skip_sum bf16", "x strided"]


@pytest.mark.parametrize("fault", FAULTS)
def test_cuda_wrapper_refuses_before_launching(fault, monkeypatch):
    """Every check the CUDA path makes before its launch, on CPU operands
    (``check_operands`` is what ``wavenet_block`` runs on a CUDA tensor);
    nothing reaches the kernel library."""
    args, kw, words = _bad(fault)
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("launched"))
    with pytest.raises(ValueError, match=re.escape(words)):
        wb.check_operands(*args, **kw)
    x, skip, part_t, mel, w = _small_operands()
    wb.check_operands(x, skip, part_t, mel, w, dilation=4, stride=16)
    meta = torch.zeros((1, 64, 256), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        wb.wavenet_block(meta, None, part_t, mel, w, dilation=1, stride=16)


# card: the DiffWave cell's longest call and the 10-s utterance
SHAPES = [(16, 896), (1, 864)]


def _card_case(card, batch, frames, dilation, kind, seed):
    gen = torch.Generator().manual_seed(seed)
    w = _weights(gen, 16, device=card)
    x, skip, part_t, mel = _operands(gen, batch, frames, frames * 256, 16,
                                     kind, device=card)
    return x, skip, part_t, mel, w


@pytest.mark.card
@pytest.mark.parametrize("dilation", DILATIONS)
@pytest.mark.parametrize("batch,frames", SHAPES)
def test_kernel_matches_plain_on_card(card, batch, frames, dilation):
    """Block 0's kind at dilation 1, the last block's (no x') at 512, a
    middle block's elsewhere: each update (x' - x sqrt(1/2), the skip
    output) within 1e-2 relative L2 of the plain version's. The two round
    z and the gate at different points (the kernel once, the plain chain
    four times), so a value near a bf16 step may round the other way."""
    kind = "first" if dilation == 1 else "later"
    x, skip, part_t, mel, w = _card_case(card, batch, frames, dilation, kind,
                                         batch + dilation)
    want_x = dilation != 512
    with torch.inference_mode():
        want = wb.wavenet_block_plain(
            x, None if skip is None else skip.clone(), part_t, mel, w,
            dilation=dilation, stride=16)
        before = wb.LAUNCHES["wavenet_block"]
        skip_in = None if skip is None else skip.clone()
        got = wb.wavenet_block(x, skip_in, part_t, mel, w,
                               dilation=dilation, stride=16, want_x=want_x)
        torch.cuda.synchronize()
    assert wb.LAUNCHES["wavenet_block"] == before + 1
    if skip_in is not None:
        assert got[1].data_ptr() == skip_in.data_ptr()
    assert bool(got[1].isfinite().all())
    if want_x:
        assert bool(got[0].isfinite().all())
        ex, es = _update_errors(got, want, x, skip)
        assert ex < 1e-2, ex
    else:
        assert got[0] is None
        es = float((got[1] - want[1]).norm() / (want[1] - skip).norm())
    assert es < 1e-2, es


def _f64_block(x, skip, part_t, mel, w, dilation):
    """The block in float64 from the same bf16-rounded weights and mel: the
    exact values both routes round."""
    d64 = torch.float64
    cond = wc.wavenet_cond_plain(torch.zeros(x.shape[0], M, x.shape[-1],
                                             dtype=BF, device=x.device),
                                 mel, w.ups, torch.eye(M, device=x.device)
                                 [:, :, None], torch.zeros(M,
                                                           device=x.device),
                                 stride=16).double()
    pt = part_t.to(BF).double() if x.dtype == BF else part_t.double()
    a = (x.double() + pt[:, :, None]).to(BF).double()
    z = F.conv1d(a, w.w_dil.to(BF).double(), w.b_dil.double(),
                 padding=dilation, dilation=dilation)
    z = z + F.conv1d(cond, w.mel_w.to(BF).double(), w.mel_b.double())
    out = torch.tanh(z[:, :C]) * torch.sigmoid(z[:, C:])
    r = F.conv1d(out, w.w_res.to(BF).double(), w.b_res.double())
    s = F.conv1d(out, w.w_skip.to(BF).double(), w.b_skip.double())
    return (x.double() + r) * math.sqrt(0.5), s + (0 if skip is None
                                                   else skip.double())


@pytest.mark.card
@pytest.mark.parametrize("dilation", [1, 16, 512])
def test_kernel_is_nearer_float64_than_plain_on_card(card, dilation):
    """One rounding fewer, never one more: against the block in float64,
    the kernel's error in each update is at most the plain version's."""
    kind = "first" if dilation == 1 else "later"
    x, skip, part_t, mel, w = _card_case(card, 1, 864, dilation, kind,
                                         70 + dilation)
    with torch.inference_mode():
        exact = _f64_block(x, skip, part_t, mel, w, dilation)
        plain = wb.wavenet_block_plain(
            x, None if skip is None else skip.clone(), part_t, mel, w,
            dilation=dilation, stride=16)
        kernel = wb.wavenet_block(x, None if skip is None else skip.clone(),
                                  part_t, mel, w, dilation=dilation,
                                  stride=16)
    for i in range(2):
        base = (x.double() * math.sqrt(0.5) if i == 0 else
                (0 if skip is None else skip.double()))
        size = (exact[i] - base).norm()
        err_k = float((kernel[i].double() - exact[i]).norm() / size)
        err_p = float((plain[i].double() - exact[i]).norm() / size)
        assert err_k <= err_p, (i, err_k, err_p)


@pytest.mark.card
def test_graph_replay_equals_eager_on_card(card):
    x, skip, part_t, mel, w = _card_case(card, 2, 96, 8, "later", 9)
    with torch.inference_mode():
        eager = wb.wavenet_block(x, skip.clone(), part_t, mel, w,
                                 dilation=8, stride=16)
        work = skip.clone()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            wb.wavenet_block(x, work, part_t, mel, w, dilation=8, stride=16)
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = wb.wavenet_block(x, work, part_t, mel, w, dilation=8,
                                   stride=16)
        work.copy_(skip)
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(out[0], eager[0]) and torch.equal(out[1], eager[1])


DIFFWAVE_HP = {"hop_size": 256, "audio_num_mel_bins": 80, "T": 1000,
               "beta_0": 1e-6, "beta_T": 0.01, "noise_schedule": "", "N": 6,
               "lr": 2e-4, "seed": 0, "max_samples": 2560,
               "max_sentences": 2, "binary_data_dir": "",
               "denoiser": "wavenet", "multiband": False,
               "compute_dtype": "bfloat16"}


@pytest.mark.card
def test_launches_per_replayed_sampler_call_on_card(card):
    """DiffWave BASE (30 blocks) at N = 6: a replayed sampler call launches
    the block kernel 30 x 6 = 180 times; a training step never."""
    from fastdiff_tpu_torch.diffusion.sampler import (constants_for_hparams,
                                                      make_sampler)
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
    before = wb.LAUNCHES["wavenet_block"]
    wav = sampler(gen, mel, length)
    torch.cuda.synchronize()
    assert wb.LAUNCHES["wavenet_block"] - before == 180
    assert sampler.replay_launches(mel, length)["wavenet_block"] == 180
    assert bool(wav.isfinite().all())

    task = FastDiffTask(dict(DIFFWAVE_HP), device=card)
    state = task.build_state(seed=0)
    batch = {"wavs": (0.3 * torch.randn((2, 2560, 1), generator=gen,
                                        device=card)).cpu().numpy(),
             "mels": (torch.randn((2, 10, M), generator=gen, device=card)
                      - 4.0).cpu().numpy()}
    before = wb.LAUNCHES["wavenet_block"]
    metrics = task.train_step(state, batch)
    torch.cuda.synchronize()
    assert wb.LAUNCHES["wavenet_block"] == before
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
