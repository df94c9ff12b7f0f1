"""Host time inside FastSpeech 2's forward (tts.acoustic) over the window."""
from portbench.tts_readers import acoustic_share as read  # noqa: F401
