"""The card idle over the traced window."""
from portbench.readers import idle_share as read  # noqa: F401
