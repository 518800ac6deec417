"""The slice's flow work at the card's peak ÷ the slice, %."""
from benchmark.readers import flow_mfu


def read(run, trace):
    return flow_mfu(trace)
