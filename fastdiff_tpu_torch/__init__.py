"""FastDiff in PyTorch for NVIDIA Hopper: the port of ``fastdiff_tpu``.

The entry point (``run.py``: the YAML config cascade, ``--infer`` through
``Trainer.test``, training and validation), the mel -> waveform serving
path (N-step reverse diffusion around the FastDiff denoiser, replayed as
one CUDA graph per shape, served over HTTP, chunked, streamed or batched)
on every inference route, the trainer, the wav / mel front end, the
binarizer, the vocoder registry with the Griffin-Lim vocoders, and the TTS
serving path (the text front end, FastSpeech 2 and
``FastSpeech2Task.infer_to_wav`` into the vocoder), BDDM's noise-schedule
search (the phi predictor, its training and the reverse search), the
objective metrics (MCD, MR-STFT, PESQ; ``evaluate``, ``demo_vocoder``)
and the other model families (the speaker encoder and its verification
training, the WaveNet and diffusion-PWG denoisers, the PWG vocoder, the
autoregressive MoL WaveNet and its task), data-parallel training and
sharded vocoding (``parallel/``), the C++ mmap data loader (``native/``)
and the profiling helpers, written as PyTorch modules. Every kernel the JAX package wrote in Pallas
(the LVC blocks, the predictor heads, the down path and the two
experiment scripts' kernels) is hand-written CUDA C++ for ``sm_90a``
(``csrc/``), built with ``nvcc`` on first use; every other op is plain
PyTorch. Entry points run on the CUDA card unless the caller asks for the
CPU; on CPU tensors each kernel wrapper runs its plain PyTorch version.

Module names follow ``fastdiff_tpu`` so each port module sits beside its
JAX counterpart. The package imports neither jax nor ``fastdiff_tpu`` nor
PyYAML: it keeps its own copies of the jax-free modules it needs
(``config``, ``diffusion/schedules``, ``data``, ``text``,
``ops/loudness``, the numpy halves of ``ops/{dsp,pitch,cwt}``,
``utils/{audio_io,multiprocess,logging_utils,metrics,pesq}``) and reads
its YAML configs itself.
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level API: ``import fastdiff_tpu_torch`` loads no torch code."""
    lazy = {
        "FastDiff": ("fastdiff_tpu_torch.models.fastdiff", "FastDiff"),
        "params_from_jax": ("fastdiff_tpu_torch.models.bridge",
                            "params_from_jax"),
        "sample": ("fastdiff_tpu_torch.diffusion.sampler", "sample"),
        "make_sampler": ("fastdiff_tpu_torch.diffusion.sampler",
                         "make_sampler"),
        "make_param_sampler": ("fastdiff_tpu_torch.diffusion.sampler",
                               "make_param_sampler"),
        "ChunkedVocoder": ("fastdiff_tpu_torch.serving.chunked_vocoder",
                           "ChunkedVocoder"),
        "DistributedChunkedVocoder": (
            "fastdiff_tpu_torch.serving.chunked_vocoder",
            "DistributedChunkedVocoder"),
        "StreamingVocoder": ("fastdiff_tpu_torch.serving.streaming_vocoder",
                             "StreamingVocoder"),
        "BatchedVocoder": ("fastdiff_tpu_torch.serving.batch_vocoder",
                           "BatchedVocoder"),
        "FastDiffVocoder": ("fastdiff_tpu_torch.vocoders.fastdiff_vocoder",
                            "FastDiffVocoder"),
        "VocoderService": ("fastdiff_tpu_torch.serving.server",
                           "VocoderService"),
        "FastSpeech2": ("fastdiff_tpu_torch.models.fastspeech2",
                        "FastSpeech2"),
        "FastSpeech2Task": ("fastdiff_tpu_torch.training.tts_task",
                            "FastSpeech2Task"),
        "TTSPipeline": ("fastdiff_tpu_torch.tts.infer", "TTSPipeline"),
        "NoisePredictor": ("fastdiff_tpu_torch.diffusion.noise_predictor",
                           "NoisePredictor"),
        "phi_loss": ("fastdiff_tpu_torch.diffusion.noise_predictor",
                     "phi_loss"),
        "search_noise_schedule": (
            "fastdiff_tpu_torch.diffusion.noise_predictor",
            "search_noise_schedule"),
        "denoise": ("fastdiff_tpu_torch.vocoders.denoise", "denoise"),
    }
    if name in lazy:
        import importlib
        module, attr = lazy[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(
        f"module 'fastdiff_tpu_torch' has no attribute '{name}'")
