"""Host ms of the ``det.resize`` spans (the numpy INTER_AREA resize to
the detector's input) that ended in the slice ÷ their frames."""
from benchmark.spans import ms_per


def read(run, trace):
    return ms_per(trace, "det.resize", "frames")
