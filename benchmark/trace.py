"""The traced slice: ``torch.profiler`` over a fixed number of calls, read
back from its Chrome trace.

What it keeps: the slice's length on the host clock; every device
operation (kernels, copies, fills) with its name, start and length; the
host's profiled operations. From them: the seconds in which something ran
on the device (the union of their intervals), kernel time by name, and the
idle gaps labelled with the innermost host operation running at the gap's
middle.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import pathlib
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


@dataclasses.dataclass
class Slice:
    calls: int
    wall_s: float
    device_ops: list  # (name, cat, start_us, dur_us), by start
    host_ops: list  # (name, start_us, dur_us)

    def kernels(self) -> list:
        return [op for op in self.device_ops if op[1] == "kernel"]

    def busy_s(self) -> float:
        """Seconds in which at least one device operation ran."""
        total, end = 0.0, float("-inf")
        for _, _, start, dur in self.device_ops:
            stop = start + dur
            if stop <= end:
                continue
            total += stop - max(start, end)
            end = stop
        return total * 1e-6

    def kernel_s(self, match) -> float:
        """Seconds of the kernels whose name ``match(name)`` accepts."""
        return sum(dur for name, _, _, dur in self.kernels() if match(name)) * 1e-6

    def top_ops(self, k: int = 10) -> list:
        by = collections.Counter()
        for name, _, _, dur in self.device_ops:
            by[name[:120]] += dur * 1e-6
        return [[n, s] for n, s in by.most_common(k)]

    def idle_gaps(self, k: int = 10) -> list:
        """The idle time between device operations, summed by the innermost
        profiled host operation at each gap's middle."""
        hosts = sorted(self.host_ops, key=lambda op: op[1])
        starts = [op[1] for op in hosts]
        by = collections.Counter()
        end = None
        for _, _, start, dur in self.device_ops:
            if end is not None and start > end:
                mid = (start + end) / 2.0
                label, best = "host, no profiled operation", None
                i = bisect.bisect_right(starts, mid)
                for name, s, d in hosts[max(0, i - 256):i]:
                    if s <= mid <= s + d and (best is None or d < best):
                        label, best = name, d
                by[label[:120]] += (start - end) * 1e-6
            end = start + dur if end is None else max(end, start + dur)
        return [[n, s] for n, s in by.most_common(k)]


def profile_calls(torch, fn, calls: int) -> Slice:
    """Run ``fn(i)`` for i in range(calls) under the profiler, the card
    synchronised at both ends; the trace goes to a file under TMPDIR that
    is removed once read."""
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(calls):
            fn(i)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", dir=os.environ.get("TMPDIR"))
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = json.loads(pathlib.Path(path).read_text()).get("traceEvents", [])
    finally:
        os.unlink(path)
    device, host = [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            device.append((ev["name"], cat, float(ev["ts"]), float(ev.get("dur", 0.0))))
        elif cat in HOST_CATS:
            host.append((ev["name"], float(ev["ts"]), float(ev.get("dur", 0.0))))
    device.sort(key=lambda op: op[2])
    return Slice(calls, wall, device, host)
