"""The TTS text front end (normalization, G2P, processors, token encoder),
copied from ``fastdiff_tpu/text``: pure Python, no torch."""
