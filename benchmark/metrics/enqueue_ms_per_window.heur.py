"""Mean host ms of the dispatch thread's ``vf.enqueue`` spans (a
window's pinned copy and its launches) that ended in the slice."""
from benchmark.spans import ms_per


def read(run, trace):
    return ms_per(trace, "vf.enqueue")
