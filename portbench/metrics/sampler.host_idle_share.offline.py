"""Card idle under the graph sampler's spans (sampler.*)."""
from portbench.program_spans import host_idle_share


def read(run):
    return host_idle_share(run, "sampler")
