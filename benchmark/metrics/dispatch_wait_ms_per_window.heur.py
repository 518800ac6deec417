"""Mean ms a window waited for the dispatch thread (``vf.queued``: from
the client's submit to the thread starting it), over the spans that
ended in the slice."""
from benchmark.spans import ms_per


def read(run, trace):
    return ms_per(trace, "vf.queued")
