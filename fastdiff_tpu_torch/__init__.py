"""FastDiff in PyTorch for NVIDIA Hopper: the inference slice of ``fastdiff_tpu``.

The mel -> waveform serving path of ``fastdiff_tpu`` (N-step reverse
diffusion around the FastDiff denoiser, served over HTTP), written as
PyTorch modules in the NCL ``(B, C, L)`` layout. The two kernels that carry
the denoiser's LVC blocks are hand-written CUDA C++ for ``sm_90a``
(``csrc/``), built with ``nvcc`` on first use; every other op is plain
PyTorch. On CPU tensors each kernel wrapper runs its plain PyTorch version.

Module names follow ``fastdiff_tpu`` so each port module sits beside its
JAX counterpart. The package never imports jax: from ``fastdiff_tpu`` it
uses only the jax-free ``config`` and ``diffusion.schedules`` modules.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level API: ``import fastdiff_tpu_torch`` loads no torch code."""
    lazy = {
        "FastDiff": ("fastdiff_tpu_torch.models.fastdiff", "FastDiff"),
        "params_from_jax": ("fastdiff_tpu_torch.models.bridge",
                            "params_from_jax"),
        "sample": ("fastdiff_tpu_torch.diffusion.sampler", "sample"),
        "FastDiffVocoder": ("fastdiff_tpu_torch.vocoders.fastdiff_vocoder",
                            "FastDiffVocoder"),
        "VocoderService": ("fastdiff_tpu_torch.serving.server",
                           "VocoderService"),
    }
    if name in lazy:
        import importlib
        module, attr = lazy[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(
        f"module 'fastdiff_tpu_torch' has no attribute '{name}'")
