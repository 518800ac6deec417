"""Device-busy ms in the slice ÷ sampled frames completed in it."""
from benchmark.readers import per


def read(run, trace):
    return None if trace is None else per(trace, 1e3 * trace.busy_s, "frames")
