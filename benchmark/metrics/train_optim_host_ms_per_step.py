"""Mean host ms of the step's ``train.optim`` spans (AdamW's update
of the leaves) that ended in the slice."""
from benchmark.spans import ms_per


def read(run, trace):
    return ms_per(trace, "train.optim")
