"""95th percentile of the window's utterance latencies, ms."""
from portbench.readers import utt_latency_p95_ms as read  # noqa: F401
