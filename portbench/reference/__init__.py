"""Plain PyTorch references of the benchmark's configurations.

Each module is named after a configuration's ``family`` and gives
``param_shapes(cfg)``, the parameters by name and shape, and
``forward(weights, cfg, audio, mel, t, quant)``, the denoiser in float32.
``diffusion.py`` holds the reverse process they share. Nothing here
imports the program: the references follow the published architectures
and take only what the benchmark itself makes (weights, mels, the seeds
of the noise).
"""
