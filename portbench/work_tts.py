"""Model FLOPs of one text-to-wav call (``kind: tts``), beside ``work.py``:
FastSpeech 2 at the sentence's token count and ``t_mel = max_frames`` (the
frames the decoder and the pitch predictor run, padding included), then the
FastDiff vocoder at the padded bucket over N steps (``work.model_flops``).
A multiply-add counts as two FLOPs; elementwise work, LayerNorm and the
softmax are not counted.
"""

from __future__ import annotations

from portbench import work


def fft_block_flops(h: int, ffn: int, k: int, t: int) -> float:
    """One pre-LN FFT block over ``t`` positions: the qkv and output
    projections, the scores and the weighted sum (over all heads), and the
    two kernel-``k`` FFN convolutions."""
    projections = 2.0 * t * h * (3 * h + h)
    attention = 2.0 * 2 * t * t * h
    return projections + attention + 2.0 * t * (h * ffn * k + ffn * h * k)


def predictor_flops(h: int, ph: int, pk: int, out: int, t: int) -> float:
    """A variance predictor: two kernel-``pk`` convolutions and the linear
    output, over ``t`` positions."""
    return 2.0 * t * (h * ph * pk + ph * ph * pk + ph * out)


def fastspeech2_flops(hp: dict, tokens: int) -> float:
    h, ffn, k = (int(hp["hidden_size"]), int(hp["ffn_hidden"]),
                 int(hp["enc_ffn_kernel_size"]))
    ph, pk = int(hp["predictor_hidden"]), int(hp["predictor_kernel"])
    t_mel = int(hp["max_frames"])
    return (int(hp["enc_layers"]) * fft_block_flops(h, ffn, k, tokens)
            + predictor_flops(h, ph, pk, 1, tokens)
            + predictor_flops(h, ph, pk, 2, t_mel)
            + int(hp["dec_layers"]) * fft_block_flops(h, ffn, k, t_mel)
            + 2.0 * t_mel * h * int(hp["audio_num_mel_bins"]))


def call_flops(hp: dict, tokens: int, padded: int) -> float:
    """One call: FastSpeech 2, then FastDiff on one row of ``padded``
    frames."""
    return fastspeech2_flops(hp, tokens) + work.model_flops("fastdiff", hp, 1,
                                                            padded)
