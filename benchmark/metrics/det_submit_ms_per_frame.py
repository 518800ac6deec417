"""Host ms of the ``det.forward`` spans (the host's side of the batch's
pageable copy and the forward's launches) that ended in the slice ÷
their frames."""
from benchmark.spans import ms_per


def read(run, trace):
    return ms_per(trace, "det.forward", "frames")
