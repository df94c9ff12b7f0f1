"""Padded frames over frames run (serving/batch_vocoder.py)."""
from portbench.readers import pad_share as read  # noqa: F401
