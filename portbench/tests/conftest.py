"""Fixtures of the benchmark's own tests.

Run on the CPU from the repository root:

    python -m pytest portbench/tests -q

and the tests that need the card, on the card's machine (whose Python has
no JAX, so the repository's root ``conftest.py`` is left out):

    python3 -m pytest --confcutdir=portbench -c /dev/null portbench/tests -m card

Tests that need the card take the ``card`` fixture, which skips them where
``torch.cuda.is_available()`` is false; the decision is made when the
test runs, never when a module is imported.
"""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# widths small enough for a CPU test; every other size is the cell's own
TINY_FASTDIFF = dict(inner_channels=8, kpnet_hidden_channels=8,
                     diffusion_step_embed_dim_in=16,
                     diffusion_step_embed_dim_mid=32,
                     diffusion_step_embed_dim_out=32)
TINY_WAVENET = dict(res_channels=8, skip_channels=8, num_res_layers=4,
                    dilation_cycle=2, diffusion_step_embed_dim_in=16,
                    diffusion_step_embed_dim_mid=32,
                    diffusion_step_embed_dim_out=32)
TINY_LENGTHS = dict(mean_s=0.06, std_s=0.03, min_s=0.02, max_s=0.1)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skips without one)")


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test: the tests run in several workers."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda:0")


def write_json(path, data):
    with open(path, "w") as f:
        json.dump(data, f, indent=1)


def read_json(path):
    with open(path) as f:
        return json.load(f)


def make_tiny_root(base) -> str:
    """A copy of ``BENCHMARK.json`` and ``portbench/`` whose configurations
    keep every size but the widths above, and whose mixes keep their form
    at a few frames an utterance (buckets of 4 frames, 3 rows a call)."""
    root = os.path.join(str(base), "checkout")
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    for name, tiny in (("fastdiff-lj", TINY_FASTDIFF),
                       ("diffwave-base-lj", TINY_WAVENET)):
        path = os.path.join(root, "portbench", "configs", f"{name}.json")
        cfg = read_json(path)
        cfg["hparams"].update(tiny)
        write_json(path, cfg)
    for name in ("offline-b16", "utt-b1"):
        path = os.path.join(root, "portbench", "traffic", f"{name}.json")
        mix = read_json(path)
        mix["lengths"].update(TINY_LENGTHS)
        mix.update(frame_bucket=4, warm_seconds=0.2)
        if mix["batch"] > 1:
            mix.update(batch=3, max_batch=3, batches_per_round=6)
        else:
            mix.update(batches_per_round=12)
        write_json(path, mix)
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)
