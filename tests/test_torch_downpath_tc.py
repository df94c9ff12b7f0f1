"""K8's two-stage decomposition, checked without a card.

``csrc/downpath.cu`` runs the down path in two launches: stage 1 writes
skip0 and, over tiles of ``STAGE1_TILE`` rate-4 samples with a halo of
``STAGE1_HALO``, DBlock 1's skip1; stage 2 reads skip1 back and runs
DBlocks 2 and 3 over tiles of ``STAGE2_TILE`` rate-256 samples. These
tests hold the Python geometry to the source's constants, reckon each
stage's halo against the receptive field built from ``required_halo``'s
terms, and run a plain tile-by-tile PyTorch model of the split (stage
tiles, halos, strided picks, zero rows outside each stage's sequence) that
must reproduce ``downpath_plain`` bit for bit.
"""

import re

import numpy as np
import pytest
import torch

from fastdiff_tpu_torch.ops import _build
from fastdiff_tpu_torch.ops import downpath_pallas as ops
from tests.fake_card import FakeCuda, fake_card
from fastdiff_tpu_torch.ops.nn import leaky_relu

C = ops.KERNEL_CHANNELS
FACTORS = ops.KERNEL_FACTORS
BF16 = torch.bfloat16
PICK3 = ops.STAGE2_HALO - 8 * ops.STAGE3_HALO   # x2 row of p3 row 0


def _source() -> str:
    return (_build.CSRC / "downpath.cu").read_text()


def _const(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_python_geometry_matches_the_source():
    src = _source()
    for name, value in (("C", C), ("K0", ops.KERNEL_TAPS),
                        ("NL", ops.KERNEL_LAYERS), ("THREADS", ops.THREADS),
                        ("BLOCKS_PER_SM", ops.BLOCKS_PER_SM),
                        ("ROW", ops.ROW), ("WROW", ops.WROW),
                        ("PAD", ops.PAD), ("T1", ops.STAGE1_TILE),
                        ("H1", ops.STAGE1_HALO), ("T3", ops.STAGE2_TILE),
                        ("H3", ops.STAGE3_HALO), ("E3", ops.STAGE3_EXT),
                        ("H2", ops.STAGE2_HALO), ("E2", ops.STAGE2_EXT)):
        assert _const(src, name) == value, name
    assert "constexpr int E1 = T1 + 2 * H1;" in src
    assert "constexpr int AOFF = 4 * H1 + 4;" in src
    assert "constexpr int ASPAN = 4 * E1 + 8;" in src
    assert "constexpr int PICK3 = H2 - 8 * H3;" in src
    # the same shared-memory formulas as SMEM1, SMEM2
    assert ("sizeof(DWeights) + ASPAN * 4 + 3 * (E1 + 2 * PAD) * ROW * 2"
            in src)
    assert ("2 * sizeof(DWeights) + 3 * (E2 + 2 * PAD) * ROW * 2" in src)


def test_shared_memory_fits_two_blocks_per_sm():
    assert ops.DWEIGHTS_BYTES % 16 == 0
    for smem in (ops.SMEM1, ops.SMEM2):
        assert ops.BLOCKS_PER_SM * (smem + 1024) <= 233_472
    # DBlock 3's three buffers fit in the bytes of DBlock 2's P
    assert 3 * (ops.STAGE3_EXT + 2 * ops.PAD) <= ops.STAGE2_EXT + 2 * ops.PAD
    # 80-byte activation rows and 208-byte weight rows: eight consecutive
    # rows in eight distinct 16-byte bank groups (conflict-free ldmatrix)
    for stride in (ops.ROW * 2, ops.WROW * 2):
        assert stride % 16 == 0
        assert len({(r * stride) % 128 for r in range(8)}) == 8


def test_halos_cover_the_receptive_field():
    """required_halo's terms: the first conv reaches (k0 - 1) / 2 input
    samples, each DBlock (2^layers - 1) samples of its own rate."""
    k0, layers = ops.KERNEL_TAPS, ops.KERNEL_LAYERS
    reach = 2 ** layers - 1                  # one DBlock, in its own rows
    r1, r2, r3 = 4, 32, 256
    assert ops.required_halo(FACTORS) >= (k0 - 1) // 2 + reach * (r1 + r2
                                                                  + r3)
    # stage 1: DBlock 1 over the tile and its halo, picks from the audio
    assert ops.STAGE1_HALO * r1 >= reach * r1
    assert ops.STAGE1_EXT == ops.STAGE1_TILE + 2 * ops.STAGE1_HALO
    first_tap = ops.AUDIO_OFF - r1 * ops.STAGE1_HALO - (k0 - 1) // 2
    last_tap = (ops.AUDIO_OFF + r1 * (ops.STAGE1_EXT - 1 - ops.STAGE1_HALO)
                + (k0 - 1) // 2)
    assert first_tap >= 0 and last_tap < ops.AUDIO_SPAN
    # skip0's own samples: [4 j0, 4 j0 + 4 T1) and their taps
    assert ops.AUDIO_OFF >= (k0 - 1) // 2
    assert ops.AUDIO_OFF + r1 * ops.STAGE1_TILE + (k0 - 1) // 2 \
        <= ops.AUDIO_SPAN
    # stage 2, DBlock 3: x3's tile plus its reach, in rate-256 rows
    assert ops.STAGE3_HALO >= reach
    assert ops.STAGE3_EXT - ops.STAGE3_HALO - ops.STAGE2_TILE >= reach
    # DBlock 2: every pick of p3 and skip2's tile lie `reach` rows inside
    # x2's buffer, whose rows are valid from `reach` to E2 - reach
    picks = [PICK3 + 8 * e for e in range(ops.STAGE3_EXT)]
    assert min(picks) >= reach and max(picks) < ops.STAGE2_EXT - reach
    assert ops.STAGE2_HALO >= reach
    assert ops.STAGE2_HALO + 8 * ops.STAGE2_TILE <= ops.STAGE2_EXT - reach
    # in input samples, stage 2 reaches back at least the deep path's field
    assert r2 * ops.STAGE2_HALO >= reach * (r2 + r3)


def test_plan_at_the_10s_shapes():
    plan = ops.downpath_plan(1, 864 * 256)
    assert (plan.stage1_blocks, plan.stage2_blocks) == (216, 108)
    assert ops.downpath_plan(2, 4096)[:2] == (8, 4)


def test_entry_arity_matches_its_signature():
    m = re.search(r'extern "C" int downpath_launch\(([^)]*)\)', _source())
    params = [p for p in m.group(1).split(",") if p.strip()]
    assert len(params) == len(_build.SIGNATURES["downpath_launch"]) == 12


def test_ncl_entry_arity_matches_its_signature():
    m = re.search(r'extern "C" int downpath_ncl_launch\(([^)]*)\)',
                  _source())
    params = [p for p in m.group(1).split(",") if p.strip()]
    assert len(params) == len(_build.SIGNATURES["downpath_ncl_launch"]) == 13
    assert "L % 2048 != 0" in _source()
    assert ops.NCL_ALIGN == 2048 == ops.required_halo(FACTORS)


def test_ncl_channel_rows_match_the_source_and_fit():
    """DBlock s's channel-major output [C][CS_s]: a row holds the buffer's
    rows and starts 16-byte aligned; CS_s = 8 mod 64, so the 32 words a
    warp writes (8 channels x 4 sample pairs) fall in 32 banks; it fits in
    the bytes of the buffer it overlays (DBlocks 1 and 2: their own Bb; 3:
    DBlock 2's A); the stored runs start on a vector."""
    src = _source()
    exts = (ops.STAGE1_EXT, ops.STAGE2_EXT, ops.STAGE3_EXT)
    region = (ops.STAGE1_EXT + 2 * ops.PAD, ops.STAGE2_EXT + 2 * ops.PAD,
              ops.STAGE2_EXT + 2 * ops.PAD)
    for i, (cs, ext, rows) in enumerate(zip(ops.NCL_ROWS, exts, region)):
        assert _const(src, f"CS{i + 1}") == cs
        assert cs >= ext and cs % 64 == 8
        assert C * cs <= rows * ops.ROW
        # one store: lane (gq, tq) writes channel gq's samples 2 tq, 2 tq + 1
        banks = {(gq * cs + 2 * tq) // 2 % 32
                 for gq in range(8) for tq in range(4)}
        assert len(banks) == 32
    for halo in (ops.STAGE1_HALO, ops.STAGE2_HALO, ops.STAGE3_HALO):
        assert halo % 8 == 0


def _rows(t, lo, hi):
    """Rows [lo, hi) of t (B, n, ch), zero outside [0, n)."""
    b, n, ch = t.shape
    out = t.new_zeros((b, hi - lo, ch))
    a, z = max(lo, 0), min(hi, n)
    if a < z:
        out[:, a - lo:z - lo] = t[:, a:z]
    return out


def _mask(t, lo, n):
    """t (B, E, ch) with the rows whose position lo + e is outside [0, n)
    set to zero."""
    pos = torch.arange(lo, lo + t.shape[1])
    keep = ((pos >= 0) & (pos < n))[None, :, None]
    return torch.where(keep, t, torch.zeros_like(t))


def _dblock(p, res_aug, conv_aug, lo, n):
    """One DBlock over a buffer of rows lo .. lo + E (p zero outside
    [0, n)): zero padding beyond the buffer, rows outside [0, n) zeroed."""
    res = ops._conv_nwc(p, res_aug, (0,))
    y = p
    for li in range(conv_aug.shape[0]):
        d = 2 ** li
        y = _mask(ops._conv_nwc(leaky_relu(y), conv_aug[li], (-d, 0, d))
                  .to(BF16), lo, n)
    return _mask(y + res.to(BF16), lo, n)


def _first_conv(audio_bf, first_aug, lo, hi):
    """x0 at input samples [lo, hi) from the audio around them."""
    half = (first_aug.shape[0] - 2) // 2
    window = _rows(audio_bf, lo - half, hi + half)
    return ops._conv_nwc(window, first_aug, range(-half, half + 1))[
        :, half:-half].to(BF16)


def downpath_tiled(audio, first_aug, res_aug, conv_aug):
    """The kernel's split, block by block, in plain PyTorch."""
    b, length, _ = audio.shape
    n1, n2, n3 = length // 4, length // 32, length // 256
    audio_bf = audio.to(BF16)
    s0 = torch.zeros((b, length, C), dtype=BF16)
    s1 = torch.zeros((b, n1, C), dtype=BF16)
    s2 = torch.zeros((b, n2, C), dtype=BF16)
    xf = torch.zeros((b, n3, C), dtype=BF16)
    t1, h1, e1 = ops.STAGE1_TILE, ops.STAGE1_HALO, ops.STAGE1_EXT
    for bx in range(-(-n1 // t1)):
        j0 = bx * t1
        hi = min(length, 4 * (j0 + t1))
        s0[:, 4 * j0:hi] = _first_conv(audio_bf, first_aug, 4 * j0,
                                       4 * (j0 + t1))[:, :hi - 4 * j0]
        g1 = j0 - h1
        # picks p1[e] = x0[4 (g1 + e)], recomputed from the audio
        p1 = _mask(_first_conv(audio_bf, first_aug, 4 * g1,
                               4 * (g1 + e1))[:, ::4], g1, n1)
        x1 = _dblock(p1, res_aug[0], conv_aug[0], g1, n1)
        hi = min(n1, j0 + t1)
        s1[:, j0:hi] = x1[:, h1:h1 + hi - j0]
    t3, h3, e3 = ops.STAGE2_TILE, ops.STAGE3_HALO, ops.STAGE3_EXT
    h2, e2 = ops.STAGE2_HALO, ops.STAGE2_EXT
    for bx in range(-(-n3 // t3)):
        j0 = bx * t3
        g2, g3 = 8 * j0 - h2, j0 - h3
        # picks p2[e] = skip1[8 (g2 + e)], read back from stage 1's output
        m = torch.arange(g2, g2 + e2)
        p2 = _mask(s1[:, (8 * m).clamp(0, n1 - 1)], g2, n2)
        x2 = _dblock(p2, res_aug[1], conv_aug[1], g2, n2)
        hi = min(n2, 8 * (j0 + t3))
        s2[:, 8 * j0:hi] = x2[:, h2:h2 + hi - 8 * j0]
        p3 = _mask(x2[:, PICK3::8][:, :e3], g3, n3)
        x3 = _dblock(p3, res_aug[2], conv_aug[2], g3, n3)
        hi = min(n3, j0 + t3)
        xf[:, j0:hi] = x3[:, h3:h3 + hi - j0]
    return s0, s1, s2, xf


def ncl_augs(first_aug, res_aug, conv_aug, bias):
    """The packs with their bias rows replaced by the NCL layout's float32
    biases (the weights stay bf16 values), for the tile model."""
    n_layers = conv_aug.shape[1]

    def aug(w, row):
        return torch.cat([w[:-1].float(), row[None]])

    first = aug(first_aug, bias[0])
    res = torch.stack([aug(res_aug[bi], bias[1 + bi * (n_layers + 1)
                                             + n_layers])
                       for bi in range(len(FACTORS))])
    conv = torch.stack([torch.stack([
        aug(conv_aug[bi, li], bias[1 + bi * (n_layers + 1) + li])
        for li in range(n_layers)]) for bi in range(len(FACTORS))])
    return first, res, conv


def _packs(rng):
    first = rng.normal(size=(ops.KERNEL_TAPS + 1, C)) * 0.3
    res = rng.normal(size=(3, C + 1, C)) * 0.15
    conv = rng.normal(size=(3, ops.KERNEL_LAYERS, 3 * C + 1, C)) * 0.1
    return tuple(torch.from_numpy(a.astype(np.float32)).to(BF16)
                 for a in (first, res, conv))


@pytest.mark.parametrize("b,length", [(2, 4096), (1, 4096), (2, 8192),
                                      (1, 2816)])
def test_tiled_model_reproduces_plain(b, length):
    """Two halo units (the smallest length the route fuses), a length that
    spans several tiles of both stages, and one that is no multiple of a
    stage-1 tile (the kernel takes any multiple of 256)."""
    rng = np.random.default_rng(length + b)
    audio = torch.from_numpy(
        rng.standard_normal((b, length, 1)).astype(np.float32))
    packs = _packs(rng)
    # oneDNN picks its CPU convolution by shape, and at batch 1 a window
    # and the whole sequence may sum a conv's products in different orders
    # (a flipped bf16 rounding); PyTorch's own convolution sums each output
    # in one order whatever the length, so the comparison is exact
    with torch.backends.mkldnn.flags(enabled=False):
        ref = ops.downpath_plain(audio, *packs, FACTORS)
        got = downpath_tiled(audio, *packs)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape, i
        assert torch.equal(g, r), (i, float((g.float() - r.float())
                                           .abs().max()))


@pytest.mark.parametrize("b,length", [(2, 4096), (1, 4096), (2, 8192),
                                      (1, 2816)])
def test_tiled_model_reproduces_ncl_plain(b, length):
    """The NCL flag: the same split with the biases in float32 (read from
    their own array, not the packs' bf16 rows) reproduces
    ``downpath_ncl_plain``, the NCL route's module chain, bit for bit, in
    NCL."""
    rng = np.random.default_rng(2 * length + b)
    audio = torch.from_numpy(
        rng.standard_normal((b, length, 1)).astype(np.float32))
    packs = _packs(rng)
    bias = torch.from_numpy(
        (rng.normal(size=(1 + 3 * (ops.KERNEL_LAYERS + 1), C)) * 0.1)
        .astype(np.float32))
    with torch.backends.mkldnn.flags(enabled=False):
        ref = ops.downpath_ncl_plain(audio, *packs, bias, FACTORS)
        got = downpath_tiled(audio, *ncl_augs(*packs, bias))
    for i, (g, r) in enumerate(zip(got, ref)):
        g = g.transpose(1, 2)
        assert g.shape == r.shape, i
        assert torch.equal(g, r), (i, float((g.float() - r.float())
                                           .abs().max()))
    # the bf16 bias rows would differ: the flag's float32 biases matter
    nwc = ops.downpath_plain(audio, *packs, FACTORS)
    assert not torch.equal(nwc[0].transpose(1, 2), ref[0])


@pytest.mark.parametrize("ncl", [False, True])
def test_each_layout_reaches_its_entry_and_counts_its_key(ncl, monkeypatch):
    """On a stand-in card, each wrapper calls its own C entry with the
    operands, four outputs of its layout, the shapes and the stream, and
    counts one launch under its own key alone."""
    lib = fake_card(monkeypatch)
    monkeypatch.setattr(ops, "LAUNCHES", dict(ops.LAUNCHES))
    b, length, c = 2, 4096, C
    audio = FakeCuda((b, length, 1), torch.float32)
    weights = (FakeCuda((8, c)), FakeCuda((3, c + 1, c)),
               FakeCuda((3, 3, 3 * c + 1, c)))
    if ncl:
        weights += (FakeCuda((13, c), torch.float32),)
    name = "downpath_ncl" if ncl else "downpath"
    wrapper = ops.downpath_ncl if ncl else ops.downpath_fused
    before = dict(ops.LAUNCHES)
    outs = wrapper(audio, *weights, FACTORS)
    (entry, args), = lib.calls
    assert entry == f"{name}_launch"
    assert len(args) == len(_build.SIGNATURES[entry])
    assert args[:1 + len(weights)] == tuple(
        t.data_ptr() for t in (audio, *weights))
    assert args[1 + len(weights):-4] == tuple(o.data_ptr() for o in outs)
    assert args[-4:] == (b, length, c, 0)
    for o, rate in zip(outs, (1, 4, 32, 256)):
        assert o.dtype == torch.bfloat16
        assert tuple(o.shape) == ((b, c, length // rate) if ncl
                                  else (b, length // rate, c))
    assert ops.LAUNCHES == dict(before, **{name: before[name] + 1})
