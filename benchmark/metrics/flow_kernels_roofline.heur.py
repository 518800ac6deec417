"""The hand-written flow kernels' share of their byte roofline, %."""
from benchmark.readers import flow_kernels_roofline


def read(run, trace):
    return flow_kernels_roofline(trace)
