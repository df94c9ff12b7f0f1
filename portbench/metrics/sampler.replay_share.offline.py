"""Sampler calls served by graph replay (diffusion/sampler.py)."""
from portbench.readers import replay_share as read  # noqa: F401
