"""Milliseconds a call: the window's time over the calls completed in it
(host clock, each call ending with its pose in host memory)."""


def read(run):
    return run.window_s / run.calls * 1e3 if run.calls else None
