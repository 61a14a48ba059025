"""Share of a call's time in which no operation ran on the device, in
percent: 100 x (1 - busy / call), with busy the seconds a call in which a
device operation ran (the union of their intervals in the traced slice,
torch.profiler) and call the seconds a call of the untraced window (host
clock). The profiler's own cost, which roughly doubles a Track call's host
time in the slice, stays out of it."""


def read(run):
    trace = run.trace
    if trace is None or not trace.device_ops or not trace.calls or not run.calls:
        return None
    return 100.0 * (1.0 - (trace.busy_s() / trace.calls) / (run.window_s / run.calls))
