"""What the program recorded of the traced slice: the port's own recorder
(``foundationpose_cpp_tpu_torch.utils.profiling.RECORDER``), which is on
while ``torch.profiler`` runs and so holds the slice's calls: their stages'
device ms (timing events inside the graphs) and their copies' bytes.

Every reader returns None where the slice ran nothing on the device (a CPU
run), where the program has no recorder, or where the recorder does not
hold exactly the slice's calls.
"""

from __future__ import annotations

from benchmark import counts


def summary(run) -> dict | None:
    """The recorder's summary of the slice's calls, or None."""
    trace = run.trace
    if trace is None or not trace.device_ops or not trace.calls:
        return None
    from foundationpose_cpp_tpu_torch.utils import profiling

    recorder = getattr(profiling, "RECORDER", None)
    if recorder is None:
        return None
    s = recorder.summary()
    return s if s["calls"] == trace.calls else None


def stage_ms(run, name: str) -> float | None:
    """Device ms a call of the graph's stage ``name`` (a stage that runs
    twice in a call summed)."""
    s = summary(run)
    return None if s is None else s["stages"].get(name)


def nets_mfu(run, stages: tuple[str, ...]) -> float | None:
    """The nets' operations a call (the benchmark's count) over the device
    seconds a call of the nets' ``stages``, as a share of the card's bf16
    dense peak, in percent."""
    if "flops" not in run.work:
        return None
    ms = [stage_ms(run, name) for name in stages]
    if any(m is None for m in ms) or sum(ms) <= 0:
        return None
    return 100.0 * run.work["flops"] / (sum(ms) * 1e-3) / counts.PEAK_BF16_FLOPS


def copy_mb(run) -> float | None:
    """Megabytes (1e6 bytes) of every copy a call issued: uploads,
    static-buffer loads, output clones and readback."""
    s = summary(run)
    return None if s is None else sum(s["bytes"].values()) / 1e6
