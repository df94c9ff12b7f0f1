"""The port never imports jax, and chip_smoke.py refuses to run without a GPU.

Both run in subprocesses: this test process has jax loaded (root conftest).
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd=REPO, timeout=120):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import fastdiff_tpu_torch\n"
            "import fastdiff_tpu_torch.models.fastdiff\n"
            "import fastdiff_tpu_torch.models.bridge\n"
            "import fastdiff_tpu_torch.diffusion.sampler\n"
            "import fastdiff_tpu_torch.vocoders.fastdiff_vocoder\n"
            "import fastdiff_tpu_torch.serving.server\n"
            "import fastdiff_tpu_torch.diffusion.losses\n"
            "import fastdiff_tpu_torch.training.optim\n"
            "import fastdiff_tpu_torch.training.checkpoint\n"
            "import fastdiff_tpu_torch.training.task\n"
            "import fastdiff_tpu_torch.training.trainer\n"
            "import fastdiff_tpu_torch.ops.lvc_block_pallas\n"
            "import fastdiff_tpu_torch.ops.downpath_pallas\n"
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
            "voc = FastDiffVocoder(hp)\n"
            "import numpy as np\n"
            "assert voc.route == 'nwc'\n"
            "assert voc.spec2wav(np.zeros((16, 16), np.float32)).shape == "
            "(4096,)\n"
            "from fastdiff_tpu_torch.vocoders.fastdiff_vocoder import "
            "model_config_from_hparams\n"
            "model_config_from_hparams({'use_pallas_block': 'auto'})\n"
            "from fastdiff_tpu_torch.models.fastdiff import "
            "resolve_train_route\n"
            "assert resolve_train_route({'use_pallas_block': 'auto'}, "
            "'cpu') == 'plain'\n"
            "assert resolve_train_route({'use_pallas_block': 'auto'}, "
            "'cuda') == 'ncl_sr'\n"
            "from fastdiff_tpu_torch.training.task import FastDiffTask\n"
            "assert FastDiffTask({'use_pallas_block': 'auto'}).route == "
            "'plain'\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m.startswith('jaxlib'))\n"
            "assert not bad, bad\n"
            "print('no-jax-ok')\n")
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr
    assert "no-jax-ok" in proc.stdout


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
