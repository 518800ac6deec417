"""Padding frames of the detector batches staged in the slice (each
padded to a power of two) ÷ the padded batches, in %."""
from benchmark.spans import share


def read(run, trace):
    return share(trace, "det.stage", lambda a: a["bucket"] - a["frames"],
                 lambda a: a["bucket"])
