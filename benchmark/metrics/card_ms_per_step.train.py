"""Card time a training step: the card's busy milliseconds from the
window's opening to its final synchronize (kernels, copies and sets,
their union), ÷ the steps launched in the window."""
from benchmark.readers import card_ms_per


def read(run, trace):
    return card_ms_per(run, "steps")
