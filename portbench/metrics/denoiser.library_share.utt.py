"""Device time outside the port's own kernels (the denoiser's plain ops)."""
from portbench.readers import library_share as read  # noqa: F401
