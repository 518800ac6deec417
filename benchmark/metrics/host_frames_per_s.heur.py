"""Sampled frames of every clip enveloped in the window ÷ the window's
seconds, on the host's clock (detector off), in the traced run."""
from benchmark.readers import rate


def read(run, trace):
    return rate(run, "frames_done")
