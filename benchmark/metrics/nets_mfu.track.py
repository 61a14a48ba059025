"""The refiner's operations a Track call (the benchmark's count from the
configuration's shapes) over the device seconds of its graph's ``refiner``
stage, as a share of the card's bf16 dense peak, in percent: the net's own
share, where ``mfu.track`` is the whole call's."""

from benchmark import program_trace


def read(run):
    return program_trace.nets_mfu(run, ("refiner",))
