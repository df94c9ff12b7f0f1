"""The port's entry path (``python -m fastdiff_tpu_torch.run --infer``)
against the JAX package's ``Trainer.test``.

Both packages read ``fastdiff_tpu/configs/ljspeech.yaml`` with the same
overrides (a small model: C = 4, 2 LVC layers, ratios 8/8/4 so the hop stays
256, f32, N = 4) and vocode the same two synthesized wavs (78 and 112
frames: no multiple of 128, both padded to the one 128-frame bucket) and
their ``.npy`` mels. The port runs ``run.main([... '--infer', '--device',
'cpu'])`` on a checkpoint holding JAX's seed weights (carried across by
``trainable_params_from_jax``), with JAX's per-utterance draws reproduced
from its key and injected; the written wavs match JAX's within 1e-3 (f32
through four steps, as ``tests/test_torch_sampler_graph.py``), with the
same names, count and lengths. The mel-dir run's checkpoint holds other
weights as parameters and JAX's seed weights as the EMA, so it matches only
if the EMA is preferred. Also: the two utterances replay one graph,
``resolve_class`` maps the configs' JAX names without importing the JAX
package, the vocoder registry resolves, ``GLMel`` runs, the server reads
``--config`` and ``scripts/vocode.py`` writes its wavs.
"""

import glob
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from fastdiff_tpu.config import ModelConfig as JaxModelConfig
from fastdiff_tpu.models.fastdiff import init_fastdiff
from fastdiff_tpu.training.task import FastDiffTask as JaxTask
from fastdiff_tpu.training.trainer import Trainer as JaxTrainer
from fastdiff_tpu.utils import hparams as jax_hparams
from fastdiff_tpu.vocoders.gl import GLMel as JaxGLMel
from fastdiff_tpu_torch import run
from fastdiff_tpu_torch.config import AudioConfig, ModelConfig
from fastdiff_tpu_torch.models.bridge import trainable_params_from_jax
from fastdiff_tpu_torch.ops.dsp import stft_magnitude_np, wav2mel_np
from fastdiff_tpu_torch.serving import server
from fastdiff_tpu_torch.training.task import FastDiffTask
from fastdiff_tpu_torch.training.trainer import Trainer
from fastdiff_tpu_torch.utils import audio_io
from fastdiff_tpu_torch.utils.hparams import set_hparams
from fastdiff_tpu_torch.vocoders import gl
from fastdiff_tpu_torch.vocoders.base import get_vocoder_cls
from fastdiff_tpu_torch.vocoders.fastdiff_vocoder import FastDiffVocoder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "fastdiff_tpu", "configs", "ljspeech.yaml")
SMALL = ("N=4,inner_channels=4,lvc_layers_each_block=2,"
         "kpnet_hidden_channels=8,diffusion_step_embed_dim_in=16,"
         "diffusion_step_embed_dim_mid=32,diffusion_step_embed_dim_out=32,"
         "compute_dtype=float32")
SR, HOP, SEED = 22050, 256, 1234


def _small(n_steps: int) -> str:
    return SMALL.replace("N=4,", f"N={n_steps},")
SECONDS = (0.9, 1.3)                  # 78 and 112 frames


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch intra-op thread: the suite runs several workers on the
    machine's cores, and torch's CPU kernels oversubscribe them (a 60-step
    training test took 135 s under five busy neighbours, 0.8 s with one
    thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _wav(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    return (0.4 * np.sin(2 * np.pi * (200 + 70 * seed) * t)
            + 0.02 * rng.standard_normal(len(t))).astype(np.float32)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("infer_inputs")
    wav_dir, mel_dir = root / "wavs", root / "mels"
    wav_dir.mkdir()
    mel_dir.mkdir()
    for i, sec in enumerate(SECONDS):
        wav = _wav(sec, i)
        audio_io.save_wav(wav, str(wav_dir / f"u{i}.wav"), SR)
        np.save(str(mel_dir / f"u{i}.npy"),
                wav2mel_np(wav, AudioConfig())[1].T)
    return {"test_input_dir": str(wav_dir), "test_mel_dir": str(mel_dir)}


class _Chdir:
    def __init__(self, path):
        self.path, self.old = path, None

    def __enter__(self):
        self.old = os.getcwd()
        os.makedirs(self.path, exist_ok=True)
        os.chdir(self.path)

    def __exit__(self, *exc):
        os.chdir(self.old)


def _preds(work_dir) -> dict:
    """{name: waveform} of the ``_pred.wav`` files of the one generated
    dir under ``work_dir``."""
    (gen,) = glob.glob(os.path.join(work_dir, "generated_*"))
    return {os.path.basename(p)[: -len("_pred.wav")]:
            audio_io.load_wav(p)[0]
            for p in sorted(glob.glob(os.path.join(gen, "*_pred.wav")))}


@pytest.fixture(scope="module")
def jax_runs(inputs, tmp_path_factory):
    """JAX's ``Trainer.test`` on an input dir with N steps, seed weights,
    threefry key of ``seed``: ``jax_runs(source, n_steps)``, each run
    once."""
    root = tmp_path_factory.mktemp("jax_infer")
    out = {}

    def run_once(source, n_steps):
        if (source, n_steps) not in out:
            with _Chdir(root / f"{source}_{n_steps}"):
                hp = jax_hparams.set_hparams(
                    config=CONFIG, exp_name="jax",
                    hparams_str=f"{_small(n_steps)},{source}="
                                f"{inputs[source]}",
                    print_hparams=False, global_hparams=False)
                results = JaxTrainer(JaxTask(hp), hp["work_dir"]).test()
                out[source, n_steps] = (hp, results,
                                        _preds(hp["work_dir"]))
        return out[source, n_steps]
    return run_once


def _jax_noise(seed=SEED, n_steps=4):
    """JAX's draws of utterance i: ``Trainer.test`` splits the key once
    per utterance, its sampler splits that key for x_T and the step keys
    (``fastdiff_tpu/diffusion/sampler.py``)."""
    def noise(index, length):
        key = jax.random.PRNGKey(seed)
        for _ in range(index + 1):
            key, sub = jax.random.split(key)
        rest, first = jax.random.split(sub)
        shape = (1, length, 1)
        x_t = torch.from_numpy(np.array(jax.random.normal(first, shape)))
        zs = [torch.from_numpy(np.array(jax.random.normal(k, shape)))
              for k in jax.random.split(rest, n_steps)]
        return x_t, zs
    return noise


def _seed_params(hp):
    params = init_fastdiff(jax.random.PRNGKey(SEED),
                           JaxModelConfig.from_hparams(hp))
    return trainable_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                            params),
                                     ModelConfig.from_hparams(hp))


def _write_checkpoint(hp, work_dir, ema: bool):
    """A port ``Trainer`` checkpoint at step 1 holding JAX's seed weights,
    as the parameters, or (``ema``) as the EMA beside other parameters."""
    task = FastDiffTask(dict(hp, ema_decay=0.5 if ema else 0),
                        device="cpu")
    state = task.build_state(seed=7)
    if ema:
        state.ema = _seed_params(hp)
    else:
        state.model.load_state_dict(_seed_params(hp))
    Trainer(task, work_dir)._maybe_save(state, 1, {})


def _run_port(root, source, path, monkeypatch, ema=False, n_steps=4):
    monkeypatch.chdir(root)
    hp = set_hparams(config=CONFIG, hparams_str=_small(n_steps),
                     print_hparams=False, global_hparams=False)
    _write_checkpoint(hp, os.path.join("checkpoints", "port"), ema)
    test = Trainer.test
    monkeypatch.setattr(Trainer, "test", lambda self, state=None: test(
        self, state, noise=_jax_noise(n_steps=n_steps)))
    # base.yaml has ema_decay: 0, an int, so an override must be an int
    overrides = (f"{_small(n_steps)},{source}={path}"
                 + (",ema_decay=1" if ema else ""))
    return run.main(["--config", CONFIG, "--exp_name", "port", "--infer",
                     "--device", "cpu", "--hparams", overrides])


@pytest.mark.parametrize("source,n_steps", [("test_input_dir", 4),
                                            ("test_mel_dir", 4),
                                            ("test_input_dir", 200)])
def test_run_infer_matches_jax_trainer_test(source, n_steps, inputs,
                                            jax_runs, tmp_path, monkeypatch):
    """At the reference's N = 4 and at its full reverse process of
    N = 200 (``--hparams N=200``: both packages resolve
    linspace(1e-4, 0.02, 200))."""
    ema = source == "test_mel_dir"
    results = _run_port(tmp_path, source, inputs[source], monkeypatch, ema,
                        n_steps)
    _, jax_results, jax_preds = jax_runs(source, n_steps)
    preds = _preds(os.path.join(tmp_path, "checkpoints", "port"))
    assert os.path.isdir(os.path.join(tmp_path, "checkpoints", "port",
                                      "generated_1_"))
    assert sorted(preds) == sorted(jax_preds)
    assert [r["item_name"] for r in results] == \
        [r["item_name"] for r in jax_results]
    for r in results:
        assert r["frames"] % 128 and r["padded_frames"] == 128
        assert len(preds[r["item_name"]]) == r["frames"] * HOP
    for name, wav in preds.items():
        assert np.isfinite(wav).all()
        np.testing.assert_allclose(wav, jax_preds[name], rtol=0, atol=1e-3)
    # the two utterances share the 128-frame bucket: one capture
    assert [r["captures"] for r in results] == [0, 1]
    if source == "test_input_dir":
        gts = glob.glob(os.path.join(tmp_path, "checkpoints", "port",
                                     "generated_1_", "*_gt.wav"))
        assert len(gts) == len(SECONDS)


def test_run_infer_without_checkpoint_runs_seed_weights(inputs, tmp_path,
                                                        monkeypatch):
    monkeypatch.chdir(tmp_path)
    results = run.main(["--config", CONFIG, "--exp_name", "seed", "--infer",
                        "--device", "cpu", "--hparams",
                        f"{SMALL},test_mel_dir={inputs['test_mel_dir']}"])
    preds = _preds(os.path.join("checkpoints", "seed"))
    assert os.path.isdir(os.path.join("checkpoints", "seed", "generated_0_"))
    assert len(results) == len(preds) == len(SECONDS)
    assert all(np.isfinite(w).all() for w in preds.values())


def test_run_refuses_the_card_it_lacks(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run.main(["--config", CONFIG, "--infer"])


def test_resolve_class_imports_no_jax_package():
    code = ("import sys, glob\n"
            "from fastdiff_tpu_torch.data.dataset import resolve_class\n"
            "from fastdiff_tpu_torch.utils.hparams import load_config_cascade\n"
            "seen = {}\n"
            f"for path in sorted(glob.glob({REPO!r} + "
            "'/fastdiff_tpu/configs/*.yaml')):\n"
            "    name = load_config_cascade(path)['task_cls']\n"
            "    seen[name] = resolve_class(name).__module__\n"
            "assert seen['fastdiff_tpu.training.task.FastDiffTask'] == "
            "'fastdiff_tpu_torch.training.task', seen\n"
            "assert seen['fastdiff_tpu.training.tts_task.FastSpeech2Task'] "
            "== 'fastdiff_tpu_torch.training.tts_task', seen\n"
            "assert seen['fastdiff_tpu.training.armol_task.MoLWaveNetTask'] "
            "== 'fastdiff_tpu_torch.training.armol_task', seen\n"
            "bad = [m for m in sys.modules if m == 'fastdiff_tpu' or "
            "m.startswith(('fastdiff_tpu.', 'jax'))]\n"
            "assert not bad, bad\n"
            "print('resolve-ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "resolve-ok" in proc.stdout


def test_pwg_denoiser_task_is_refused():
    """micro_lj_pwg.yaml's task is the port's FastDiffTask with
    ``denoiser: pwg``. The port refused it until the zoo was ported; now it
    builds the config's diffusion PWG (30 layers, 3 stacks, 64 / 128 / 64,
    scales 4 x 4) and resolves no LVC kernel route."""
    from fastdiff_tpu_torch.models.pwg import PWGConfig
    hp = set_hparams(config=os.path.join(REPO, "fastdiff_tpu", "configs",
                                         "micro_lj_pwg.yaml"),
                     print_hparams=False, global_hparams=False)
    task = FastDiffTask(hp, device="cpu")
    assert task.denoiser_type == "pwg" and task.route is None
    assert task.model_cfg == PWGConfig(
        layers=30, stacks=3, residual_channels=64, gate_channels=128,
        skip_channels=64, upsample_scales=(4, 4, 4, 4))


@pytest.mark.parametrize("name,cls", [
    ("fastdiff", FastDiffVocoder), ("FastDiff", FastDiffVocoder),
    ("glmel", gl.GLMel), ("GLLinear", gl.GLLinear), ("stft", gl.STFT),
    ("fastdiff_tpu.vocoders.gl.GLLinear", gl.GLLinear),
    ("fastdiff_tpu.vocoders.fastdiff_vocoder.FastDiff", FastDiffVocoder),
    ("fastdiff_tpu_torch.vocoders.gl.STFT", gl.STFT)])
def test_vocoder_names_resolve(name, cls):
    assert get_vocoder_cls({"vocoder": name}) is cls


def test_unknown_vocoder_names_raise():
    """Names the registry lacks raise; ``pwg`` (refused until the PWG
    vocoder was ported) resolves by name and by JAX's class path."""
    from fastdiff_tpu_torch.vocoders.pwg_vocoder import PWG
    with pytest.raises(ValueError, match="unknown vocoder 'hifigan'"):
        get_vocoder_cls({"vocoder": "hifigan"})
    with pytest.raises(NotImplementedError, match="not ported"):
        get_vocoder_cls({"vocoder": "fastdiff_tpu.vocoders.hifigan.HifiGAN"})
    assert get_vocoder_cls({"vocoder": "pwg"}) is PWG
    assert get_vocoder_cls(
        {"vocoder": "fastdiff_tpu.vocoders.pwg_vocoder.PWG"}) is PWG


def test_glmel_runs_and_converges_as_jax_s():
    """``vocoder: GLMel`` on the CPU: the tone of JAX's registry test
    survives mel -> GL -> waveform, and the spectral convergence is within
    5 % of JAX's GLMel (the initial phases differ: JAX draws from
    PRNGKey(0), the port from a CPU generator seeded 0)."""
    hp = {"griffin_lim_iters": 20}
    t = np.arange(SR // 2) / SR
    wav = (0.6 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
    _, mel = wav2mel_np(wav, AudioConfig())
    rec = get_vocoder_cls({"vocoder": "GLMel"})(hp, device="cpu").spec2wav(
        mel.T)
    ref = JaxGLMel(hp).spec2wav(mel.T)
    assert rec.shape == ref.shape and np.isfinite(rec).all()
    freq = np.fft.rfftfreq(len(rec), 1 / SR)
    assert abs(freq[np.argmax(np.abs(np.fft.rfft(rec)))] - 440.0) < 25.0

    def convergence(y):
        got = stft_magnitude_np(y, 1024, 256, 1024)
        want = stft_magnitude_np(wav, 1024, 256, 1024)
        n = min(got.shape[1], want.shape[1])
        return np.linalg.norm(got[:, :n] - want[:, :n]) / np.linalg.norm(
            want[:, :n])
    assert convergence(rec) <= 1.05 * convergence(ref)


def test_server_reads_config(monkeypatch, tmp_path):
    seen = []
    monkeypatch.setattr(server, "serve", lambda hp, **kw: seen.append(hp))
    monkeypatch.chdir(tmp_path)
    server.main(["--config", CONFIG, "--hparams", "N=4,use_pallas_block=ncl",
                 "--device", "cpu"])
    want = set_hparams(config=CONFIG, hparams_str="N=4,use_pallas_block=ncl",
                       print_hparams=False, global_hparams=False)
    assert seen[0] == want and seen[0]["lr"] == "2e-4"
    server.main(["--hparams", json.dumps({"N": 4}), "--device", "cpu"])
    assert seen[1] == {"N": 4}


def test_vocode_script_writes_wavs(inputs, tmp_path, monkeypatch):
    from fastdiff_tpu_torch.scripts import vocode
    monkeypatch.chdir(tmp_path)
    assert vocode.main(["--config", CONFIG, "--input",
                        inputs["test_mel_dir"], "--out", "out", "--hparams",
                        SMALL, "--device", "cpu", "--batch", "2"]) == 0
    for i, sec in enumerate(SECONDS):
        wav, sr = audio_io.load_wav(os.path.join("out", f"u{i}.wav"))
        mel = np.load(os.path.join(inputs["test_mel_dir"], f"u{i}.npy"))
        assert sr == SR and len(wav) == mel.shape[0] * HOP
        assert np.isfinite(wav).all()


def test_run_fits_then_validates(inputs, tmp_path, monkeypatch):
    """No flag trains (``Trainer.fit``) and saves the merged config;
    ``--validate`` with ``--exp_name`` alone reads that config back and
    evaluates the restored checkpoint. The data is the port's binarizer's,
    run on the test wavs."""
    from fastdiff_tpu_torch.data.binarizer import VocoderBinarizer
    monkeypatch.chdir(tmp_path)
    with open("metadata_phone.csv", "w") as f:
        f.write("item_name,wav_fn\n")
        for name in sorted(os.listdir(inputs["test_input_dir"])):
            f.write(f"{name[:-4]},"
                    f"{os.path.join(inputs['test_input_dir'], name)}\n")
    overrides = (f"{SMALL},processed_data_dir={tmp_path},"
                 f"binary_data_dir={tmp_path / 'binary'},test_num=1,N_PROC=1,"
                 "max_samples=8192,max_sentences=1,max_updates=2,"
                 "val_check_interval=2,num_sanity_val_steps=0,"
                 "tb_log_interval=1")
    hp = set_hparams(config=CONFIG, hparams_str=overrides,
                     print_hparams=False, global_hparams=False)
    VocoderBinarizer(hp).process()
    fit = run.main(["--config", CONFIG, "--exp_name", "fit", "--device",
                    "cpu", "--hparams", overrides])
    assert fit["step"] == 2 and np.isfinite(fit["val"]["loss"])
    assert os.path.exists(os.path.join("checkpoints", "fit", "config.yaml"))
    val = run.main(["--exp_name", "fit", "--validate", "--device", "cpu"])
    assert np.isfinite(val["loss"])


@pytest.mark.parametrize("name", ["GLLinear", "STFT"])
def test_gl_linear_and_stft_vocoders(name):
    """The other two Griffin-Lim vocoders on the CPU: a log10 linear
    magnitude (GLLinear) or a raw one (STFT) of a tone back to a waveform
    of frames * 256 samples whose spectral convergence is within 5 % of
    JAX's vocoder of the same name."""
    import fastdiff_tpu.vocoders.gl as jax_gl
    hp = {"griffin_lim_iters": 20}
    t = np.arange(SR // 2) / SR
    wav = (0.5 * np.sin(2 * np.pi * 330.0 * t)).astype(np.float32)
    mag = stft_magnitude_np(wav, 1024, 256, 1024)          # (bins, frames)
    spec = (np.log10(np.maximum(mag, 1e-6)) if name == "GLLinear"
            else mag).T
    rec = get_vocoder_cls({"vocoder": name})(hp, device="cpu").spec2wav(spec)
    ref = getattr(jax_gl, name)(hp).spec2wav(spec)
    assert rec.shape == ref.shape == (spec.shape[0] * HOP,)

    def convergence(y):
        got = stft_magnitude_np(y, 1024, 256, 1024)
        n = min(got.shape[1], mag.shape[1])
        return np.linalg.norm(got[:, :n] - mag[:, :n]) / np.linalg.norm(
            mag[:, :n])
    assert convergence(rec) <= 1.05 * convergence(ref)


def test_cli_module_runs_on_the_cpu(inputs, tmp_path):
    """``python -m fastdiff_tpu_torch.run ... --infer --device cpu`` as a
    process: exit 0, the mean RTF printed, one ``_pred.wav`` per mel."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "fastdiff_tpu_torch.run", "--config", CONFIG,
         "--exp_name", "cli", "--infer", "--device", "cpu", "--hparams",
         f"{SMALL},test_mel_dir={inputs['test_mel_dir']}"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "mean RTF" in proc.stdout
    preds = _preds(str(tmp_path / "checkpoints" / "cli"))
    assert len(preds) == len(SECONDS)
