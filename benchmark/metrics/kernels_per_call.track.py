"""Kernels (not copies or fills) the device ran a call in the traced slice."""


def read(run):
    if run.trace is None or not run.trace.calls or not run.trace.kernels():
        return None
    return len(run.trace.kernels()) / run.trace.calls
