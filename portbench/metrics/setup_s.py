"""Process start to the first timed call, s."""


def read(run):
    return run.setup_s
