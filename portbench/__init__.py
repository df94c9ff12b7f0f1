"""The benchmark of ``fastdiff_tpu_torch``: ``python3 portbench/run.py
--workload <cell> --seed <n> --seconds <s> --trace <0|1>`` runs one cell of
``BENCHMARK.json`` once and prints its result as the last line."""
