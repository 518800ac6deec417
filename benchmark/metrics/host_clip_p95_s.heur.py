"""95th percentile of every clip's latency in the window, from its send
to its envelope, on the host's clock, in the traced run."""
from benchmark.readers import p95


def read(run, trace):
    return p95(run.data.get("latencies", []))
