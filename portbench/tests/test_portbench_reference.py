"""The plain references against the port at small widths on the CPU, in
float32: the denoisers, the reverse process's scalars and loop, and the
weights the benchmark makes loading strictly into the program."""

import numpy as np
import pytest
import torch

from portbench import weights as weightlib
from portbench.reference import common, diffusion, fastdiff, wavenet

from .conftest import ROOT, TINY_FASTDIFF, TINY_WAVENET, read_json


def config(name, tiny):
    hp = read_json(f"{ROOT}/portbench/configs/{name}.json")["hparams"]
    return dict(hp, compute_dtype="float32", **tiny)


def program_model(hp, weights):
    from fastdiff_tpu_torch.training.task import FastDiffTask
    return FastDiffTask(dict(hp), device="cpu").inference_model(weights)


def rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("name,tiny,ref", [
    ("fastdiff-lj", TINY_FASTDIFF, fastdiff),
    ("diffwave-base-lj", TINY_WAVENET, wavenet)])
def test_denoiser_matches_the_port(name, tiny, ref):
    hp = config(name, tiny)
    weights = weightlib.make(ref.param_shapes(hp), 3, "cpu")
    model = program_model(hp, weights)
    gen = torch.Generator().manual_seed(0)
    frames = 6
    audio = torch.randn(2, frames * 256, generator=gen)
    mel = torch.randn(2, frames, 80, generator=gen) - 4.0
    t = torch.tensor([12.5, 700.25])
    with torch.no_grad():
        got = model(audio[..., None], mel, t[:, None])[..., 0]
    with common.exact_float32():
        want = ref.forward(weights, hp, audio, mel, t)
    assert got.shape == want.shape
    assert rel(got, want) < 1e-5


@pytest.mark.parametrize("n_steps", [4, 6])
def test_step_scalars_match_the_port(n_steps):
    from fastdiff_tpu_torch.diffusion.sampler import (constants_for_hparams,
                                                      step_coefficients)
    hp = dict(read_json(f"{ROOT}/portbench/configs/fastdiff-lj.json")
              ["hparams"], N=n_steps)
    constants = constants_for_hparams(hp)
    coef = step_coefficients(constants, ddim=False)
    ours = diffusion.steps(hp)
    assert len(ours) == n_steps
    for i, (t, c_eps, c_x, sigma) in enumerate(ours):
        # the port holds the schedules in float32, the reference in float64:
        # near t = 0, where alpha is 1 - 1e-6, the float32 tables move a
        # mapped step by up to 5e-3 of a step and the small coefficients of
        # the last steps by up to 2e-6 (x and eps are of order 1)
        assert t == pytest.approx(float(constants.steps[i]), abs=5e-3)
        np.testing.assert_allclose([c_eps, c_x, sigma], coef[i], rtol=1e-4,
                                   atol=1e-5)


def test_reverse_process_matches_the_port_sampler():
    from fastdiff_tpu_torch.diffusion.sampler import (constants_for_hparams,
                                                      sample)
    hp = config("fastdiff-lj", TINY_FASTDIFF)
    weights = weightlib.make(fastdiff.param_shapes(hp), 4, "cpu")
    model = program_model(hp, weights)
    mel = torch.randn(2, 5, 80, generator=torch.Generator().manual_seed(1))
    length = 5 * 256
    # the program draws from a generator; the reference draws the same
    # values again from the call's seed, in DDPM's order
    with torch.no_grad():
        got = sample(model, mel, constants_for_hparams(hp), length,
                     generator=torch.Generator().manual_seed(77))[..., 0]
    x_t, zs = diffusion.draws(77, 2, length, 4, "cpu")
    with common.exact_float32():
        want = diffusion.reverse(fastdiff.forward, weights, hp, mel, x_t, zs,
                                 common.identity)
    assert rel(got, want) < 1e-5


def test_weights_load_strictly_and_fold_weight_norm():
    hp = config("diffwave-base-lj", TINY_WAVENET)
    shapes = wavenet.param_shapes(hp)
    weights = weightlib.make(shapes, 11, "cpu")
    again = weightlib.make(shapes, 11, "cpu")
    assert all(torch.equal(weights[k], again[k]) for k in shapes)
    v, g = weights["blocks.0.dilated_conv.v"], weights["blocks.0.dilated_conv.g"]
    assert torch.allclose(common.weight_norm(v, g), v, rtol=1e-5, atol=1e-7)
    bound = (64 * 3) ** -0.5 if hp["res_channels"] == 64 else \
        (hp["res_channels"] * 3) ** -0.5
    assert float(v.abs().max()) <= bound
    assert float(weights["out_conv.weight"].abs().max()) > 0
    program_model(hp, weights)          # strict: names and shapes agree
    with pytest.raises(RuntimeError):
        program_model(hp, {k: w for k, w in weights.items()
                           if k != "out_conv.bias"})


def test_fp8_control_rounds_to_three_mantissa_bits():
    x = torch.linspace(-3.0, 5.0, 1001)
    y = common.fp8_round(x)
    assert float(y.abs().max()) == pytest.approx(5.0)
    err = float(((y - x).abs() / x.abs().clamp_min(0.05)).max())
    assert 1e-2 < err < 0.07
