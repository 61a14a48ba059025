"""The nets' operations a Register (the benchmark's count from the
configuration's shapes) over the device seconds of its graph's
``refiner`` and ``scorer`` stages, as a share of the card's bf16 dense
peak, in percent: the nets' own share, where ``mfu.register`` is the
whole call's."""

from benchmark import program_trace


def read(run):
    return program_trace.nets_mfu(run, ("refiner", "scorer"))
