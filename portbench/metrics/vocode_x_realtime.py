"""Unpadded audio seconds returned over the window's seconds."""
from portbench.readers import vocode_x_realtime as read  # noqa: F401
