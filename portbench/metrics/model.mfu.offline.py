"""Model FLOPs over the window at the bf16 peak."""
from portbench.readers import mfu as read  # noqa: F401
