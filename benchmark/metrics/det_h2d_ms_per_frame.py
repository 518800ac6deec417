"""Device ms of pageable host→device copies (the detector's batches) in
the slice ÷ frames scored in it."""
from benchmark.readers import pageable_h2d_s, per


def read(run, trace):
    return None if trace is None else per(trace, 1e3 * pageable_h2d_s(trace),
                                          "frames")
