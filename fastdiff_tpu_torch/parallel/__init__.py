"""Data parallelism across processes and sharded inference across devices."""
