"""Every step's frames over the window (which ends in a synchronize), on
the host's clock, in the traced run."""
from benchmark.readers import rate


def read(run, trace):
    return rate(run, "train_frames")
