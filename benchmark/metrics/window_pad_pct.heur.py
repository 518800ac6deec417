"""Padding frames of the device windows enqueued in the slice (the tail
windows' quarter-chunk buckets) ÷ their bucketed lengths, in %."""
from benchmark.spans import share


def read(run, trace):
    return share(trace, "vf.enqueue", lambda a: a["pad"],
                 lambda a: a["frames"])
