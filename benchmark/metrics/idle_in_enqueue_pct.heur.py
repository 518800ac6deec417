"""Of the card's idle time in the slice, the share (%) that the thread
whose launch ended each gap (the dispatch thread) spent inside
``vf.enqueue``: the card waiting on the window's enqueue, not on a window
to enqueue."""
from benchmark.spans import idle_charged


def read(run, trace):
    return idle_charged(trace, ("vf.enqueue",))
