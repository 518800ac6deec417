"""Mean host ms of the step's ``train.forward`` spans (the loss's
forward: the step's launches up to the loss) that ended in the slice."""
from benchmark.spans import ms_per


def read(run, trace):
    return ms_per(trace, "train.forward")
