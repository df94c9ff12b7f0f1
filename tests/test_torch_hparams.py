"""The port's config layer (``fastdiff_tpu_torch/utils/hparams.py``,
``config.py:ModelConfig.from_hparams``) against the JAX package's and
PyYAML.

- The port's YAML reader gives what ``yaml.safe_load`` gives on every config
  of ``fastdiff_tpu/configs/`` (``lr: 2e-4`` is the string ``'2e-4'``), on
  what ``yaml.safe_dump`` writes and on what its own writer writes.
- ``set_hparams`` equals JAX's (``==`` on the dicts) for every config, with
  overrides; a config.yaml saved by either package is read back by the
  other to the same dict.
- YAML outside the subset raises and names the line; the port reads configs
  without importing PyYAML.
"""

import argparse
import glob
import math
import os
import subprocess
import sys

import pytest
import yaml

from fastdiff_tpu.config import ModelConfig as JaxModelConfig
from fastdiff_tpu.utils import hparams as jax_hparams
from fastdiff_tpu_torch.config import ModelConfig
from fastdiff_tpu_torch.utils import hparams as port_hparams
from fastdiff_tpu_torch.utils.hparams import (YamlError, apply_overrides,
                                              dump_yaml, load_yaml,
                                              parse_yaml)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "fastdiff_tpu", "configs",
                                        "*.yaml")))
NAMES = [os.path.basename(p) for p in CONFIGS]
OVERRIDES = ("N=4,upsample_ratios=[8 8 4],lr=1e-3,new_key=5,"
             "binarization_args.with_wav=False,new.nested=x")


def test_every_config_is_found():
    assert len(CONFIGS) == 9


@pytest.mark.parametrize("path", CONFIGS, ids=NAMES)
def test_reader_equals_safe_load(path):
    with open(path) as f:
        want = yaml.safe_load(f)
    assert load_yaml(path) == want
    cascade = port_hparams.load_config_cascade(path)
    assert cascade == jax_hparams.load_config_cascade(path)
    for text in (yaml.safe_dump(cascade), dump_yaml(cascade)):
        assert parse_yaml(text) == cascade
        assert yaml.safe_load(text) == cascade


def test_scalars_typed_as_yaml_1_1():
    got = load_yaml(os.path.join(REPO, "fastdiff_tpu", "configs",
                                 "base.yaml"))
    assert got["lr"] == "2e-4" and got["mel_eps"] == 1e-6
    assert got["N"] == "" and got["scheduler"] == "none"
    assert got["use_weight_norm"] is True and got["mesh_axes"] == ["dp"]
    text = ("a: yes\nb: Off\nc: ~\nd: 1_000\ne: .5\nf: -.inf\ng: .NaN\n"
            "h: 'it''s # not a comment'  # a comment\ni: \"x\\ty\"\n"
            "j: 0\nk: +12\nl: 1.0e+3\nm: y\nn: [a b, 'c', [1, []], {}]\n")
    want = yaml.safe_load(text)
    got = parse_yaml(text)
    assert math.isnan(got.pop("g")) and math.isnan(want.pop("g"))
    assert got == want


def test_writer_round_trips_through_both_readers():
    cfg = {"a": 1e-6, "b": "2e-4", "c": "true", "d": [1, [2, "x y"], "it's"],
           "e": {}, "f": {"g": None, "h": float("inf"), "i": {"j": -3}},
           "k": "", "l": "a: b", "m": "#x", "n": "0x10", "o o": 1.5,
           "p": "1234", "q": "null", "r": 12345678901234567890}
    for text in (dump_yaml(cfg), yaml.safe_dump(cfg)):
        assert parse_yaml(text) == cfg
        assert yaml.safe_load(text) == cfg
    with pytest.raises(YamlError):
        dump_yaml({"a": "two\nlines"})


@pytest.mark.parametrize("text,line", [
    ("a: 1\nb: &anchor 2", 2),
    ("a: !!str 1", 1),
    ("a: |\n  block", 1),
    ("a: b\n  continued", 2),
    ("a:\n- x: 1", 2),
    ("a: 0x10", 1),
    ("a: 017", 1),
    ("a: 2001-12-14", 1),
    ("a: 1:20", 1),
    ("a:\n\tb: 1", 2),
    ("---\na: 1", 1),
    ("a: 'open", 1),
    ("a: *ref", 1),
    ("a: b: c", 1),
    ("a: [1, 2", 1),
    ("a: {b: 1}", 1),
    ("x: 1\ny:\n  - 1\n   - 2", 4),
], ids=lambda v: repr(v) if isinstance(v, str) else None)
def test_outside_the_subset_raises_with_its_line(text, line):
    with pytest.raises(YamlError, match=rf"<yaml>:{line}:"):
        parse_yaml(text)


def _set(module, path, exp_name, overrides, reset=False, infer=False):
    args = argparse.Namespace(config=path, exp_name=exp_name,
                              hparams=overrides, infer=infer, validate=False,
                              reset=reset, remove=False, debug=False)
    return module.set_hparams(print_hparams=False, global_hparams=False,
                              args=args)


@pytest.mark.parametrize("path", CONFIGS, ids=NAMES)
def test_set_hparams_equals_jax(path, tmp_path, monkeypatch):
    """Each package in its own directory, the same exp_name: the merged
    dicts (work_dir included) are equal, and each package reads the
    config.yaml the other saved back to that dict."""
    results = {}
    for name, module in (("jax", jax_hparams), ("port", port_hparams)):
        os.makedirs(tmp_path / name)
        monkeypatch.chdir(tmp_path / name)
        results[name] = _set(module, path, "exp", OVERRIDES)
        assert os.path.exists("checkpoints/exp/config.yaml")
    assert results["port"] == results["jax"]
    cfg = results["port"]
    assert cfg["lr"] == "1e-3" and cfg["N"] == "4"
    assert cfg["upsample_ratios"] == [8, 8, 4]
    assert cfg["binarization_args"]["with_wav"] is False
    assert cfg["new_key"] == 5 and cfg["new"] == {"nested": "x"}

    # a saved config wins over the file; each reads the other's
    for reader, writer in (("port", "jax"), ("jax", "port")):
        monkeypatch.chdir(tmp_path / writer)
        module = port_hparams if reader == "port" else jax_hparams
        again = _set(module, "", "exp", "", infer=True)
        assert again == dict(results[writer], infer=True)


def test_override_type_coercion():
    """tests/test_hparams.py:test_override_type_coercion on the port."""
    cfg = {"lr": 2e-4, "n": 5, "flag": True, "lst": [1, 2], "d": {"k": 1},
           "s": "x"}
    apply_overrides(cfg, "lr=1e-5,n=7,flag=False,lst=[3 4 5],d.k=9,s=hello,"
                         "new=0.5")
    assert cfg["lr"] == 1e-5 and isinstance(cfg["lr"], float)
    assert cfg["n"] == 7 and isinstance(cfg["n"], int)
    assert cfg["flag"] is False and cfg["lst"] == [3, 4, 5]
    assert cfg["d"]["k"] == 9 and cfg["s"] == "hello" and cfg["new"] == 0.5


@pytest.mark.parametrize("overrides", [
    "", "upsample_ratios=[8 8 4],inner_channels=16",
    "lvc_layers_each_block=2,dropout=0,use_weight_norm=False,"
    "compute_dtype=float32"])
def test_model_config_casts_as_jax(overrides, tmp_path, monkeypatch):
    """ModelConfig.from_hparams against JAX's on every shared field, from
    the reader's strings and the overrides' values."""
    monkeypatch.chdir(tmp_path)
    hp = _set(port_hparams, CONFIGS[NAMES.index("ljspeech.yaml")], "",
              overrides)
    hp["inner_channels"] = str(hp["inner_channels"])
    port, jax_cfg = ModelConfig.from_hparams(hp), \
        JaxModelConfig.from_hparams(hp)
    for field in ModelConfig.__dataclass_fields__:
        assert getattr(port, field) == getattr(jax_cfg, field), field
    assert isinstance(port.inner_channels, int)
    assert port.upsample_ratios == (8, 8, 4) and port.total_hop == 256


def test_set_hparams_imports_no_yaml(tmp_path):
    code = ("import sys\n"
            "from fastdiff_tpu_torch.utils.hparams import set_hparams\n"
            f"hp = set_hparams(config={CONFIGS[NAMES.index('ljspeech.yaml')]!r}, "
            "exp_name='e', print_hparams=False)\n"
            "assert hp['lr'] == '2e-4', hp['lr']\n"
            "assert 'yaml' not in sys.modules\n"
            "print('no-yaml-ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "no-yaml-ok" in proc.stdout
    assert (tmp_path / "checkpoints" / "e" / "config.yaml").exists()
