"""Stage timing and tracing: the reference's MESSURE_DURATION macros.

Counterpart of ``foundationpose_cpp_tpu.utils.profiling``. The reference
wraps every pipeline stage in MESSURE_DURATION_AND_CHECK_STATE
(foundationpose_utils.hpp:86-93), logging microseconds per call. PyTorch
launches on the card return before the work is done, so a stage's host time
means something only after ``sync`` on what it produced; ``trace`` records
a ``torch.profiler`` timeline for kernel-level attribution.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict

import torch

logger = logging.getLogger("foundationpose_cpp_tpu_torch")


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def sync(tree) -> None:
    """Wait for the card(s) holding any tensor of ``tree`` (a tensor, or
    nested dicts, lists and tuples of them); CPU tensors are ready already."""
    for dev in {t.device for t in _tensors(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


class StageTimer:
    """Accumulating per-stage wall-clock timer (FPSCounter + duration macros).

    >>> timer = StageTimer()
    >>> with timer.stage("refine") as h:
    ...     h["result"] = program(...)
    >>> timer.report()

    A stage ends after ``sync`` on ``h["result"]`` when it is set.
    """

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync_result: bool = True):
        t0 = time.perf_counter()
        holder = {}
        try:
            yield holder
        finally:
            if sync_result and "result" in holder:
                sync(holder["result"])
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            logger.info("[%s] %.2f ms", name, dt * 1e3)

    def mean_ms(self, name: str) -> float:
        return self.totals[name] / max(self.counts[name], 1) * 1e3

    def report(self) -> str:
        lines = [
            f"{name}: {self.mean_ms(name):8.2f} ms avg over {self.counts[name]}"
            for name in sorted(self.totals)
        ]
        text = "\n".join(lines)
        logger.info("stage timing:\n%s", text)
        return text


class FPSCounter:
    """Rolling throughput counter (simple_tests fps_counter.h equivalent)."""

    def __init__(self) -> None:
        self._t0: float | None = None
        self._frames = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()
        self._frames = 0

    def count(self, n: int = 1) -> None:
        if self._t0 is None:
            self.start()
        self._frames += n

    @property
    def fps(self) -> float:
        if self._t0 is None or self._frames == 0:
            return 0.0
        return self._frames / (time.perf_counter() - self._t0)


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block, CPU and (with a card) CUDA
    activity; writes ``log_dir/trace.json`` (Chrome / Perfetto format) and
    yields the profiler, whose ``key_averages()`` sums time by kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def stacked_ms(fn, stacks, device: torch.device, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn(*(s[i] for s in stacks))`` over every i of
    the stacks: the JAX harnesses' scan over distinct stacked inputs, so no
    call reuses another's input. Each of ``warmup`` calls on input 0 comes
    first (cuDNN picks its algorithms for a shape on its first call). On the
    card the calls are queued between two CUDA events, then one synchronize;
    on the CPU the host clock times them."""
    first = [s[0] for s in stacks]
    for _ in range(warmup):
        fn(*first)
    iters = len(stacks[0])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            fn(*(s[i] for s in stacks))
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*(s[i] for s in stacks))
    return (time.perf_counter() - t0) * 1e3 / iters


@contextlib.contextmanager
def full_f32():
    """cuDNN convolutions in full f32 within the block (its default rounds
    f32 inputs to TF32); cuBLAS matrix products keep PyTorch's default,
    full f32."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before
