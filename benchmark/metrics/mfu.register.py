"""The nets' operations (the benchmark's own count from the
configuration's shapes) times the calls of the window, over the window's
time, as a share of the card's bf16 dense peak, in percent: the whole
call's share of the peak (host clock), not the nets' own, which moves only
with the call's time."""

from benchmark import counts


def read(run):
    if not run.calls or "flops" not in run.work:
        return None
    return 100.0 * run.work["flops"] * run.calls / run.window_s / counts.PEAK_BF16_FLOPS
