"""Of the card's idle time in the slice, the share (%) that the thread
whose launch ended each gap spent inside ``det.resize``, ``det.stage`` or
``det.forward``: the card waiting on a client's detector input path."""
from benchmark.spans import idle_charged


def read(run, trace):
    return idle_charged(trace, ("det.resize", "det.stage", "det.forward"))
