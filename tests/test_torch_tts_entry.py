"""The port's text-to-wav entry, ``FastSpeech2Task.synthesize``, on the CPU
at small widths (FastSpeech 2 at hidden 32, 1 + 1 layers, ``max_frames``
128; FastDiff at C = 4, 2 LVC layers, f32, N = 4), its duration
predictor's output bias raised so that a phone gets a few frames.

With ``infer_frame_bucket`` set the mel is vocoded through a
``BatchedVocoder`` at that bucket: where the bucket equals the mel's length
the waveform is the unbucketed route's (the registry vocoder at the mel's
own length) bit for bit, on the same noise; ten distinct lengths inside one
bucket run one graph (one eager call, one capture, eight replays). Under
``torch.profiler`` a call is one ``tts.call`` span holding ``tts.acoustic``
(with ``tts.length`` inside) and ``tts.vocode`` (holding the vocoder's
spans), whatever the number of layers, and no ``tts.*`` span lies inside
the sampler's; without a profiler no ``RecordFunction`` is entered. The
task counts the calls, their tokens and their predicted frames.

The acoustic half runs through ``tts/acoustic_graphs.py:AcousticGraphs``:
on the CPU its protocol (one warm-up and one capture a token count, the
least recently used evicted, a moved parameter dropping every graph) with
the forward's own outputs; on the card (``card`` marker) replays equal to
the eager forward, two token counts replayed in turns from one pool, and a
returned output that the next replay leaves alone.
"""

import collections
import os

import numpy as np
import pytest
import torch

from fastdiff_tpu_torch.models.fastspeech2 import FastSpeech2, FS2Config
from fastdiff_tpu_torch.serving.batch_vocoder import BatchedVocoder
from fastdiff_tpu_torch.training.tts_task import FastSpeech2Task
from fastdiff_tpu_torch.tts.acoustic_graphs import AcousticGraphs
from fastdiff_tpu_torch.utils.hparams import set_hparams
from fastdiff_tpu_torch.vocoders.fastdiff_vocoder import FastDiffVocoder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "fastdiff_tpu", "configs", "fs2_ljspeech.yaml")
SMALL = ("hidden_size=32,enc_layers={layers},dec_layers={layers},"
         "ffn_hidden=64,enc_ffn_kernel_size=9,max_frames=128,"
         "N=4,inner_channels=4,lvc_layers_each_block=2,"
         "kpnet_hidden_channels=8,diffusion_step_embed_dim_in=16,"
         "diffusion_step_embed_dim_mid=32,diffusion_step_embed_dim_out=32,"
         "compute_dtype=float32")
TTS_SPANS = ("tts.call", "tts.acoustic", "tts.length", "tts.vocode")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch intra-op thread: the suite runs several workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _task(bucket: int = 0, layers: int = 1):
    overrides = SMALL.format(layers=layers)
    if bucket:
        overrides += f",infer_frame_bucket={bucket}"
    hp = set_hparams(config=CONFIG, hparams_str=overrides,
                     print_hparams=False, global_hparams=False)
    task = FastSpeech2Task(hp, device="cpu")
    state = task.build_state(seed=0)
    with torch.no_grad():       # ~3.5 frames a phone
        state.model.dur_predictor.out.bias.fill_(1.5)
    return task, state


def _tokens(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(1, 100, n)


def test_bucketed_route_equals_the_unbucketed_at_the_mel_length():
    tokens = _tokens(12)
    plain, plain_state = _task()
    frames = plain.infer_mel(plain_state, tokens).shape[0]
    assert frames > 2 * len(tokens)
    bucketed, bucketed_state = _task(bucket=frames)
    for _ in range(3):      # eager, capture, replay: one generator each side
        want, _ = plain.synthesize(plain_state, tokens)
        got, out = bucketed.synthesize(bucketed_state, tokens)
        assert got.shape == (frames * 256,)
        np.testing.assert_array_equal(got, want)
    assert isinstance(plain.vocoder, FastDiffVocoder)
    assert isinstance(bucketed.vocoder, BatchedVocoder)
    assert int(out["mel_mask"][0].sum()) == frames


def test_lengths_inside_one_bucket_replay_one_graph():
    task, state = _task(bucket=128)
    sizes = range(8, 28, 2)
    lengths = []
    for i, n in enumerate(sizes):
        wav, _ = task.synthesize(state, _tokens(n, seed=i))
        assert wav.shape[0] % 256 == 0 and np.isfinite(wav).all()
        lengths.append(wav.shape[0] // 256)
    assert len(set(lengths)) >= 8 and max(lengths) <= 128
    sampler = task.vocoder.sampler
    assert (sampler.warmups, sampler.captures) == (1, 1)
    assert sampler.graphs_cached == 1
    assert task.counters == {"calls": len(sizes), "tokens": sum(sizes),
                             "frames": sum(lengths)}


def test_no_record_function_without_a_profiler(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    task, state = _task(bucket=64)
    for _ in range(3):
        task.synthesize(state, _tokens(10))
    assert entered == []


def _spans(prof) -> list:
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(("tts.", "vocoder.", "sampler.")):
            out.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                        e.name()))
    return sorted(out)


def _inside(span, spans, prefix) -> bool:
    return any(s <= span[0] and span[1] <= t for s, t, n in spans
               if n.startswith(prefix) and (s, t) != span[:2])


@pytest.mark.parametrize("layers", [1, 2])
def test_tts_spans_of_each_call(layers):
    task, state = _task(bucket=64, layers=layers)
    tokens = _tokens(10)
    for n in range(3):      # the vocoder warms, captures, then replays
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            task.synthesize(state, tokens)
        spans = _spans(prof)
        count = collections.Counter(name for _, _, name in spans)
        assert {name: count[name] for name in TTS_SPANS} == dict.fromkeys(
            TTS_SPANS, 1)
        assert sum(v for k, v in count.items() if k.startswith("tts.")) == 4
        assert count["vocoder.vocode"] == 1
        assert count[("sampler.warm", "sampler.capture",
                      "sampler.replay")[n]] == 1
        by_name = {name: (s, t, name) for s, t, name in spans}
        assert _inside(by_name["tts.acoustic"], spans, "tts.call")
        assert _inside(by_name["tts.vocode"], spans, "tts.call")
        assert _inside(by_name["tts.length"], spans, "tts.acoustic")
        assert _inside(by_name["vocoder.vocode"], spans, "tts.vocode")
        for span in spans:
            if span[2].startswith("tts."):
                assert not _inside(span, spans, "sampler."), span
                assert not _inside(span, spans, "vocoder."), span


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda:0")


def _acoustic_model(device="cpu"):
    model = FastSpeech2(FS2Config(hidden=32, enc_layers=1, dec_layers=1,
                                  ffn_hidden=64, max_len=128), seed=0)
    with torch.no_grad():
        model.dur_predictor.out.bias.fill_(1.5)
    return model.to(device)


def _equal(got: dict, want: dict, atol: float = 0.0):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if value is None:
            assert got[key] is None, key
        else:
            torch.testing.assert_close(got[key], value, rtol=0, atol=atol,
                                       msg=key)


@torch.no_grad()
def test_acoustic_graphs_protocol_on_the_cpu():
    model = _acoustic_model()
    graphs = AcousticGraphs(model, max_graphs=2)
    ten, twelve, eight = (torch.from_numpy(_tokens(n, seed=n))[None]
                          for n in (10, 12, 8))
    for tokens in (ten, ten, ten, twelve, twelve):
        _equal(graphs(tokens), model(tokens))
    assert (graphs.warmups, graphs.captures, graphs.graphs_cached) == (2, 2, 2)
    graphs(eight)               # a third count evicts the least recent, 10
    graphs(ten)                 # which starts again from its warm-up
    assert (graphs.warmups, graphs.captures) == (4, 2)
    model.to(torch.float64)     # the parameters moved: every graph dropped
    model.to(torch.float32)
    graphs(twelve)
    assert (graphs.warmups, graphs.captures, graphs.graphs_cached) == (5, 2, 0)
    with pytest.raises(ValueError):
        AcousticGraphs(model, max_graphs=0)


@pytest.mark.card
@torch.no_grad()
def test_acoustic_graphs_replay_the_forward_on_the_card(card):
    model = _acoustic_model(card)
    graphs = AcousticGraphs(model)
    ten, twelve = (torch.from_numpy(_tokens(n, seed=n))[None].to(card)
                   for n in (10, 12))
    for tokens in (ten, ten, twelve, twelve):   # warm and capture each
        graphs(tokens)
    assert (graphs.warmups, graphs.captures, graphs.graphs_cached) == (2, 2, 2)
    held = graphs(ten)
    want_ten = model(ten)
    _equal(held, want_ten, atol=1e-5)
    assert torch.equal(held["mel2ph"], want_ten["mel2ph"])
    for tokens in (twelve, ten, twelve):        # turns through one pool
        got, want = graphs(tokens), model(tokens)
        _equal(got, want, atol=1e-5)
        assert torch.equal(got["mel2ph"], want["mel2ph"])
    _equal(held, want_ten, atol=1e-5)           # a clone: left alone
