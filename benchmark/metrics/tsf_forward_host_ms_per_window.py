"""Host ms of the ``det.forward`` spans (the windows' copy to the card
and the forward's launches) that ended in the slice ÷ their windows."""
from benchmark.spans import ms_per


def read(run, trace):
    return ms_per(trace, "det.forward", "windows")
