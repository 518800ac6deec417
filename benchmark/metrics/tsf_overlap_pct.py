"""Frames of the detector's windows staged in the slice that an earlier
window of their clip already scores (the overlapping last windows) ÷ the
windows' frames, in %: Σ (``bucket`` − ``frames``) ÷ Σ ``bucket`` of the
``det.stage`` spans."""
from benchmark.spans import share


def read(run, trace):
    return share(trace, "det.stage", lambda a: a["bucket"] - a["frames"],
                 lambda a: a["bucket"])
