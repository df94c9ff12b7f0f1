"""Both models' FLOPs a call over the window at the bf16 peak."""
from portbench.tts_readers import mfu as read  # noqa: F401
