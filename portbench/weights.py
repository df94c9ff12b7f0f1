"""Weights from the seed, made on the run's device in one draw.

The shapes come from the configuration's plain reference
(``reference/<family>.py:param_shapes``); the program loads them by name
(a strict ``load_state_dict``), so a program whose parameters differ from
the reference's is refused at set-up. Every weight and weight-norm ``v``
is U(-1/sqrt(fan_in), 1/sqrt(fan_in)) with fan_in its elements over its
first dimension (PyTorch's default range), every bias takes its weight's
range, and every weight-norm gain ``g`` is ``v``'s norm, so the folded
weight equals ``v``.
"""

from __future__ import annotations

import math

import torch

from portbench.traffic import WEIGHTS, seed_for


def make(shapes: dict, seed: int, device) -> dict:
    """{name: float32 tensor on ``device``} for ``shapes``."""
    gen = torch.Generator(device=device).manual_seed(seed_for(seed, WEIGHTS))
    sizes = [math.prod(shape) for shape in shapes.values()]
    flat = torch.empty(sum(sizes), device=device).uniform_(-1.0, 1.0,
                                                           generator=gen)
    raw = dict(zip(shapes, (t.view(shape) for t, shape in
                            zip(flat.split(sizes), shapes.values()))))
    bounds, out = {}, {}
    for name, t in raw.items():
        prefix, leaf = name.rsplit(".", 1)
        if leaf in ("weight", "v"):
            bounds[prefix] = (t.numel() // t.shape[0]) ** -0.5
            out[name] = t * bounds[prefix]
    for name, t in raw.items():
        prefix, leaf = name.rsplit(".", 1)
        if leaf == "bias":
            out[name] = t * bounds[prefix]
        elif leaf == "g":
            v = out[f"{prefix}.v"]
            out[name] = (v.norm() if t.dim() == 0 else
                         v.flatten(1).norm(dim=1).reshape(t.shape))
    return {name: out[name] for name in shapes}
