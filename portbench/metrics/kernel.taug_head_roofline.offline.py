"""K3 (Kernel A) at its roofline."""
from portbench.readers import roofline


def read(run):
    return roofline(run, "taug_head")
