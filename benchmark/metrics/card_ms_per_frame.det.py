"""Card time a sampled frame: the card's busy milliseconds from the
window's opening until every clip sent in it has drained (kernels,
copies and sets, their union), ÷ the sampled frames of those clips."""
from benchmark.readers import card_ms_per_frame


def read(run, trace):
    return card_ms_per_frame(run)
