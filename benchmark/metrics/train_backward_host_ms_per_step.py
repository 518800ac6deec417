"""Mean host ms of the step's ``train.backward`` spans (autograd's
gradients of every leaf) that ended in the slice."""
from benchmark.spans import ms_per


def read(run, trace):
    return ms_per(trace, "train.backward")
