"""K1 + K2 (Kernel B) at their roofline."""
from portbench.readers import roofline


def read(run):
    return roofline(run, "lvc_block")
