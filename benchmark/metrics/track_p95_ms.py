"""95th percentile of every call's latency in the window, in milliseconds
(host clock, each call ending with its pose in host memory)."""


def read(run):
    return run.p95_s() * 1e3 if run.calls else None
