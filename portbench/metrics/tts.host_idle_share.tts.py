"""Card idle under the text-to-wav entry's own spans (tts.*)."""
from portbench.tts_readers import host_idle_share as read  # noqa: F401
