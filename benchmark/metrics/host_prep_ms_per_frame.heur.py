"""Host ms of the program's ``vf.host_prep`` spans (the C++ host prep of
a chunk: gray, the 320² and 32² planes, the texture) that ended in the
slice ÷ their frames."""
from benchmark.spans import ms_per


def read(run, trace):
    return ms_per(trace, "vf.host_prep", "frames")
