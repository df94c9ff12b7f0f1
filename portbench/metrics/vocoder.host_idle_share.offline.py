"""Card idle under the batch vocoder's spans (vocoder.*)."""
from portbench.program_spans import host_idle_share


def read(run):
    return host_idle_share(run, "vocoder")
