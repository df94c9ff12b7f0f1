"""The port never imports jax or the JAX package, its entry points run on the
card unless asked for the CPU, and chip_smoke.py refuses to run without a GPU.

The import checks run in subprocesses (this test process has jax loaded by
the root conftest) and, statically, over the sources.
"""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd=REPO, timeout=120):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import fastdiff_tpu_torch\n"
            "import fastdiff_tpu_torch.config\n"
            "import fastdiff_tpu_torch.diffusion.schedules\n"
            "import fastdiff_tpu_torch.data.dataset\n"
            "import fastdiff_tpu_torch.utils.logging_utils\n"
            "import fastdiff_tpu_torch.utils.timing\n"
            "import fastdiff_tpu_torch.ops.lvc_block_ncl\n"
            "import fastdiff_tpu_torch.scripts.bench_mosaic_micro\n"
            "import fastdiff_tpu_torch.scripts.exp_r4b\n"
            "import fastdiff_tpu_torch.models.fastdiff\n"
            "import fastdiff_tpu_torch.models.bridge\n"
            "import fastdiff_tpu_torch.diffusion.sampler\n"
            "import fastdiff_tpu_torch.vocoders.fastdiff_vocoder\n"
            "import fastdiff_tpu_torch.serving.server\n"
            "import fastdiff_tpu_torch.serving.chunked_vocoder\n"
            "import fastdiff_tpu_torch.serving.streaming_vocoder\n"
            "import fastdiff_tpu_torch.serving.batch_vocoder\n"
            "from fastdiff_tpu_torch import (BatchedVocoder, ChunkedVocoder, "
            "StreamingVocoder, make_param_sampler, make_sampler)\n"
            "import fastdiff_tpu_torch.diffusion.losses\n"
            "import fastdiff_tpu_torch.training.optim\n"
            "import fastdiff_tpu_torch.training.checkpoint\n"
            "import fastdiff_tpu_torch.training.task\n"
            "import fastdiff_tpu_torch.training.trainer\n"
            "import fastdiff_tpu_torch.ops.lvc_block_pallas\n"
            "import fastdiff_tpu_torch.ops.downpath_pallas\n"
            "import fastdiff_tpu_torch.run\n"
            "import fastdiff_tpu_torch.utils.hparams\n"
            "import fastdiff_tpu_torch.utils.audio_io\n"
            "import fastdiff_tpu_torch.utils.multiprocess\n"
            "import fastdiff_tpu_torch.utils.ckpt_import\n"
            "import fastdiff_tpu_torch.ops.dsp\n"
            "import fastdiff_tpu_torch.ops.loudness\n"
            "import fastdiff_tpu_torch.data.binarizer\n"
            "import fastdiff_tpu_torch.data.binarize\n"
            "import fastdiff_tpu_torch.vocoders.base\n"
            "import fastdiff_tpu_torch.vocoders.gl\n"
            "import fastdiff_tpu_torch.scripts.vocode\n"
            "import fastdiff_tpu_torch.text.normalize\n"
            "import fastdiff_tpu_torch.text.syllabify\n"
            "import fastdiff_tpu_torch.text.zh_norm\n"
            "import fastdiff_tpu_torch.text.zh_g2p\n"
            "import fastdiff_tpu_torch.text.processors\n"
            "import fastdiff_tpu_torch.text.encoder\n"
            "import fastdiff_tpu_torch.ops.pitch\n"
            "import fastdiff_tpu_torch.ops.cwt\n"
            "import fastdiff_tpu_torch.models.transformer\n"
            "import fastdiff_tpu_torch.models.fastspeech2\n"
            "import fastdiff_tpu_torch.training.tts_task\n"
            "import fastdiff_tpu_torch.tts.infer\n"
            "import fastdiff_tpu_torch.scripts.demo_tts\n"
            "from fastdiff_tpu_torch import FastSpeech2Task, TTSPipeline\n"
            "import fastdiff_tpu_torch.ops.mel_losses\n"
            "import fastdiff_tpu_torch.utils.plot\n"
            "import fastdiff_tpu_torch.data.align\n"
            "import fastdiff_tpu_torch.data.tts_binarizer\n"
            "import fastdiff_tpu_torch.data.zh_binarizer\n"
            "import fastdiff_tpu_torch.data.pre_align\n"
            "import fastdiff_tpu_torch.data.pre_align_cli\n"
            "import fastdiff_tpu_torch.utils.pesq\n"
            "import fastdiff_tpu_torch.utils.metrics\n"
            "import fastdiff_tpu_torch.vocoders.denoise\n"
            "import fastdiff_tpu_torch.diffusion.noise_predictor\n"
            "import fastdiff_tpu_torch.scripts.bddm_search\n"
            "import fastdiff_tpu_torch.scripts.evaluate\n"
            "import fastdiff_tpu_torch.scripts.demo_vocoder\n"
            "from fastdiff_tpu_torch import (NoisePredictor, "
            "search_noise_schedule)\n"
            "from fastdiff_tpu_torch.utils.metrics import mcd\n"
            "import fastdiff_tpu_torch.models.spk_encoder\n"
            "import fastdiff_tpu_torch.training.spk_task\n"
            "import fastdiff_tpu_torch.models.wavenet\n"
            "import fastdiff_tpu_torch.models.pwg\n"
            "import fastdiff_tpu_torch.models.wavenet_mol\n"
            "import fastdiff_tpu_torch.ops.mixture\n"
            "import fastdiff_tpu_torch.training.armol_task\n"
            "import fastdiff_tpu_torch.vocoders.pwg_vocoder\n"
            "import fastdiff_tpu_torch.parallel.mesh\n"
            "import fastdiff_tpu_torch.data.native_io\n"
            "import fastdiff_tpu_torch.utils.profiling\n"
            "import fastdiff_tpu_torch.scripts.e2e_sanity\n"
            "import fastdiff_tpu_torch.scripts.ddp_steps\n"
            "import fastdiff_tpu_torch.scripts.bench_n1000\n"
            "import fastdiff_tpu_torch.scripts.bench_trainstep\n"
            "import fastdiff_tpu_torch.scripts.drive_ncl_sr\n"
            "import fastdiff_tpu_torch.scripts.streaming_latency_curve\n"
            "import fastdiff_tpu_torch.scripts.graft_entry\n"
            "import fastdiff_tpu_torch.scripts.race_trees\n"
            "import fastdiff_tpu_torch.scripts.race_sampler_paths\n"
            "from fastdiff_tpu_torch import DistributedChunkedVocoder\n"

            "import numpy\n"
            "assert mcd(numpy.full(4096, 0.1), numpy.full(4096, 0.1)) == 0.0\n"
            "from fastdiff_tpu_torch.text.processors import "
            "get_txt_processor_cls\n"
            "for name in ('en', 'zh'):\n"
            "    assert get_txt_processor_cls(name).process('Hi 12')[0]\n"
            "from fastdiff_tpu_torch.vocoders import get_vocoder_cls\n"
            "assert get_vocoder_cls({'vocoder': 'glmel'}).__name__ == "
            "'GLMel'\n"
            "from fastdiff_tpu_torch.data.dataset import resolve_class\n"
            "assert resolve_class('fastdiff_tpu.training.task.FastDiffTask')"
            ".__module__ == 'fastdiff_tpu_torch.training.task'\n"
            "assert resolve_class('fastdiff_tpu.training.tts_task."
            "FastSpeech2Task') is FastSpeech2Task\n"
            "assert resolve_class('fastdiff_tpu.training.armol_task."
            "MoLWaveNetTask').__module__ == "
            "'fastdiff_tpu_torch.training.armol_task'\n"
            "assert get_vocoder_cls({'vocoder': 'pwg'}).__module__ == "
            "'fastdiff_tpu_torch.vocoders.pwg_vocoder'\n"
            "for path in ('data.tts_binarizer.TTSBinarizer', "
            "'data.zh_binarizer.ZhBinarizer', 'data.pre_align.TTSPreAlign', "
            "'data.pre_align.LJPreAlign'):\n"
            "    assert resolve_class('fastdiff_tpu.' + path).__module__ == "
            "'fastdiff_tpu_torch.' + path.rsplit('.', 1)[0]\n"
            "assert 'matplotlib' not in sys.modules\n"
            "from fastdiff_tpu_torch.models.fastdiff import (FastDiff, "
            "resolve_down_kernel, resolve_infer_route)\n"
            "assert resolve_infer_route({'use_pallas_block': True}) == "
            "'nwc'\n"
            "assert resolve_down_kernel({'use_pallas_down': 'true'})\n"
            "from fastdiff_tpu_torch.vocoders.fastdiff_vocoder import "
            "FastDiffVocoder\n"
            "hp = {'inner_channels': 8, 'cond_channels': 16, "
            "'kpnet_hidden_channels': 8, 'diffusion_step_embed_dim_in': 16, "
            "'diffusion_step_embed_dim_mid': 32, "
            "'diffusion_step_embed_dim_out': 32, 'use_pallas_block': True, "
            "'use_pallas_down': True}\n"
            "voc = FastDiffVocoder(hp, device='cpu')\n"
            "import numpy as np\n"
            "assert voc.route == 'nwc'\n"
            "assert voc.spec2wav(np.zeros((16, 16), np.float32)).shape == "
            "(4096,)\n"
            "from fastdiff_tpu_torch.config import ModelConfig\n"
            "ModelConfig.from_hparams({'use_pallas_block': 'auto'})\n"
            "from fastdiff_tpu_torch.models.fastdiff import "
            "resolve_train_route\n"
            "assert resolve_train_route({'use_pallas_block': 'auto'}, "
            "'cpu') == 'plain'\n"
            "assert resolve_train_route({'use_pallas_block': 'auto'}, "
            "'cuda') == 'ncl_sr'\n"
            "from fastdiff_tpu_torch.training.task import FastDiffTask\n"
            "assert FastDiffTask({'use_pallas_block': 'auto'}, "
            "device='cpu').route == 'plain'\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m.startswith('jaxlib'))\n"
            "assert not bad, bad\n"
            "bad = sorted(m for m in sys.modules if m == 'fastdiff_tpu' "
            "or m.startswith('fastdiff_tpu.'))\n"
            "assert not bad, bad\n"
            "assert 'yaml' not in sys.modules\n"
            "print('no-jax-ok')\n")
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr
    assert "no-jax-ok" in proc.stdout


def _imported_modules(path: pathlib.Path) -> list:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            names.append(node.module)
    return names


def test_every_jax_module_has_a_port_counterpart():
    """Each Python module and C++ source of ``fastdiff_tpu/`` has a file of
    the same path in ``fastdiff_tpu_torch/``, and ``resolve_class`` maps
    the public names of the last three modules ported to the port's."""
    root = pathlib.Path(REPO)
    jax_pkg, port = root / "fastdiff_tpu", root / "fastdiff_tpu_torch"
    sources = [p.relative_to(jax_pkg) for p in jax_pkg.rglob("*")
               if p.suffix in (".py", ".cpp") and "__pycache__" not in p.parts]
    assert len(sources) > 50
    missing = [str(rel) for rel in sources if not (port / rel).exists()]
    assert not missing, missing
    from fastdiff_tpu_torch.data.dataset import resolve_class
    for path in ("parallel.mesh.shard_batch", "parallel.mesh.replicate",
                 "data.native_io.NativeDatasetBuilder",
                 "utils.profiling.device_timer_slope",
                 "serving.chunked_vocoder.DistributedChunkedVocoder"):
        got = resolve_class("fastdiff_tpu." + path)
        assert got.__module__ == "fastdiff_tpu_torch." + path.rsplit(".", 1)[0]


# root scripts with no twin in fastdiff_tpu_torch/scripts/, and why
NO_TWIN = {
    "exp_trace_sampler.py": "covered by scripts/profile_sampler.py --graph",
    "exp_trace_train.py": "covered by scripts/profile_sampler.py --train",
    "make_micro_lj.py": "reads the reference's egs/audios, audio that is "
                        "not in the repository",
    **{name: "probes TPU (XLA / Mosaic) lowerings only" for name in (
        "exp_batchfold.py", "exp_layout.py", "exp_taug_ab.py",
        "perf_experiments.py", "exp_r4c.py", "exp_r4d.py", "exp_r4e.py",
        "exp_r5a.py", "exp_r5b.py", "exp_r5c.py", "exp_r5d.py",
        "exp_r5e.py", "exp_r5f.py", "exp_r5g.py", "exp_r5h.py",
        "exp_batchscale2.py", "exp_floor.py", "bench_megakernel.py",
        "bench_kernel_ablation.py")},
}


def test_every_root_script_has_a_twin_or_a_reason():
    """Each ``scripts/*.py`` and ``__graft_entry__.py`` has a twin of the
    same name in ``fastdiff_tpu_torch/scripts/`` (``graft_entry.py`` for
    the entry), or is named in ``NO_TWIN`` with its reason; no script of
    ``NO_TWIN`` has a twin, and each of them exists."""
    root = pathlib.Path(REPO)
    twins = root / "fastdiff_tpu_torch" / "scripts"
    scripts = {p.name: p.name for p in (root / "scripts").glob("*.py")}
    scripts["__graft_entry__.py"] = "graft_entry.py"
    assert len(scripts) > 30
    missing = [name for name, twin in scripts.items()
               if not (twins / twin).exists() and name not in NO_TWIN]
    assert not missing, missing
    assert not [name for name in NO_TWIN if (twins / name).exists()]
    assert set(NO_TWIN) <= set(scripts), set(NO_TWIN) - set(scripts)
    assert all(reason for reason in NO_TWIN.values())


def test_port_sources_import_nothing_of_the_jax_side():
    """Every module of the port and chip_smoke.py, read as source: no
    import of jax, jaxlib, fastdiff_tpu or a fastdiff_tpu module, at any
    depth (a function-level import counts too), and no PyYAML, which the
    card's machine lacks (the port reads its configs itself)."""
    root = pathlib.Path(REPO)
    files = sorted((root / "fastdiff_tpu_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    assert len(files) > 20
    bad = [(str(f.relative_to(root)), name) for f in files
           for name in _imported_modules(f)
           if name.split(".")[0] in ("jax", "jaxlib", "fastdiff_tpu", "yaml")]
    assert not bad, bad


def test_entry_points_default_to_the_card():
    """Without a device the vocoder, the server, the tasks and the script
    twins ask for the CUDA card; with no card they raise and never fall
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    from fastdiff_tpu_torch.serving.server import VocoderService
    from fastdiff_tpu_torch.training.task import FastDiffTask
    from fastdiff_tpu_torch.vocoders.fastdiff_vocoder import FastDiffVocoder
    hp = {"inner_channels": 8, "cond_channels": 16,
          "kpnet_hidden_channels": 8, "diffusion_step_embed_dim_in": 16,
          "diffusion_step_embed_dim_mid": 32,
          "diffusion_step_embed_dim_out": 32}
    from fastdiff_tpu_torch.vocoders.gl import GLMel
    from fastdiff_tpu_torch.training.tts_task import FastSpeech2Task
    for make in (FastDiffVocoder, VocoderService, FastDiffTask, GLMel,
                 FastSpeech2Task):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(dict(hp))
    # the model families ported with the speaker encoder and the zoo
    from fastdiff_tpu_torch.models.spk_encoder import (SpeakerEncoder,
                                                       get_speaker_encoder)
    from fastdiff_tpu_torch.training.armol_task import MoLWaveNetTask
    from fastdiff_tpu_torch.training.spk_task import train_spk_encoder
    from fastdiff_tpu_torch.vocoders.pwg_vocoder import PWG
    mels = [np.zeros((40, 80), np.float32)]
    for make in (lambda: FastDiffTask({"denoiser": "wavenet"}),
                 lambda: FastDiffTask({"denoiser": "pwg"}),
                 lambda: MoLWaveNetTask({"hop_size": 256}),
                 lambda: PWG({}), SpeakerEncoder,
                 lambda: get_speaker_encoder(""),
                 lambda: train_spk_encoder(mels, steps=1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    # the script twins of the full reverse process and the graft entry
    from fastdiff_tpu_torch.scripts import bench_n1000, drive_ncl_sr
    from fastdiff_tpu_torch.scripts import graft_entry
    for make in (lambda: bench_n1000.build(4), drive_ncl_sr.drive,
                 graft_entry.entry, lambda: graft_entry.dryrun_multichip(2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_chip_smoke_fails_without_gpu():
    proc = _run([os.path.join(REPO, "chip_smoke.py")])
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    with open(os.path.join(REPO, "chip_smoke.py")) as src:
        lone.write_text(src.read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
