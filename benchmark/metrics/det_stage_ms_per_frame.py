"""Host ms of the ``det.stage`` spans (the flip to RGB, the float32
scale and the padding to the bucket) that ended in the slice ÷ their
frames."""
from benchmark.spans import ms_per


def read(run, trace):
    return ms_per(trace, "det.stage", "frames")
