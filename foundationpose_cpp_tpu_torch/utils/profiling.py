"""Tracing of the program's own work, and timing helpers.

Counterpart of ``foundationpose_cpp_tpu.utils.profiling``, whose stage
timer stood for the reference's MESSURE_DURATION macros
(foundationpose_utils.hpp:86-93). On the card a stage's host time says
little: a public call is a graph replay, whose launch returns before the
work is done. So the port records, in ``RECORDER``:

- host spans of each public call: the root (``register``,
  ``register_with_scores``, ``track``, ``track_batch``) and its steps
  ``check``, ``mask``, ``names`` (a ``track_batch`` over names: their
  catalog indices mapped and uploaded), ``upload``, ``program`` (with the
  spans ``load``, ``replay`` and ``clone``) and ``readback``, each step opened by ``step``
  and closed by the next; while a ``torch.profiler`` session runs each
  span is also a ``record_function("fp.<name>")`` range, so the spans sit
  in its Chrome trace on the device trace's clock;
- the device ms of each stage of the graph a call replayed, from the
  timing events that ``programs.stage`` records into the graph at its
  capture, read after the call's readback (which has waited for them);
- the bytes each call copies, by kind: ``upload_pageable`` and
  ``upload_pinned`` (host to device), ``load`` (into a graph's static
  buffers), ``clone`` (of a graph's outputs) and ``readback`` (device to
  host); the launches of each counted kernel wrapper a call's graph
  replays made (``ops.cuda_build.COUNTERS``: ``render_views`` is K2's); and
  the process's graph captures and replays and the models' mesh-catalog
  builds (``FoundationPose.track_batch`` over names builds its model's
  catalog of every registered mesh once; a capture after the warm-up is a
  batch size met first while serving).

The recorder is off unless ``tracing()`` is active or a profiler session
runs; off, a public call costs a few attribute checks (about a
microsecond). ``trace`` records a ``torch.profiler`` timeline (kernels,
copies and the program's spans).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import os
import time
from typing import Any

import torch


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


# torch rebinds ``_is_profiler_enabled`` in this module when a profiler
# session starts and ends
_autograd_profiler = torch.autograd.profiler


@dataclasses.dataclass(slots=True)
class Call:
    """What the recorder kept of one public call: its spans in the order
    they opened (the root first), each a tuple (call id, name, start ns,
    end ns, index of the enclosing span in ``spans`` or -1 for the root),
    times by ``time.perf_counter_ns``; the device milliseconds of its
    graph's stages in the graph's order, (name, ms) with a name that may
    repeat; the bytes of its copies by kind; the launches its graph replays
    made, by counted wrapper. Once the call ends, its spans
    and stages are tuples of numbers and strings, which Python's collector
    stops tracking: a full buffer adds little to its collections."""

    id: int
    spans: list | tuple = dataclasses.field(default_factory=list)
    stages: list | tuple = dataclasses.field(default_factory=list)
    bytes: dict = dataclasses.field(default_factory=dict)
    launches: dict = dataclasses.field(default_factory=dict)
    pending: Any = None  # the Program whose stage events this call has not read yet


class _Off:
    """The span of a call that is not recorded: enters and exits, nothing more."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


OFF = _Off()


class _Open:
    """An open span of the recorder's current call; while a profiler runs it
    is also a ``record_function("fp.<name>")`` range on the trace's clock."""

    __slots__ = ("rec", "name", "index", "parent", "start_ns", "annotation")

    def __init__(self, rec: "Recorder", name: str) -> None:
        self.rec, self.name = rec, name

    def __enter__(self) -> None:
        rec = self.rec
        if rec._call is None:  # a public call: the root span of a new call
            if not rec._recording:  # the first call of a stretch in which the recorder is on
                rec.clear()
                rec._recording = True
            rec._call = Call(next(rec._ids))
        call = rec._call
        self.annotation = None
        if _autograd_profiler._is_profiler_enabled:
            self.annotation = _autograd_profiler.record_function("fp." + self.name)
            self.annotation.__enter__()
        self.index = len(call.spans)
        self.parent = rec._open[-1] if rec._open else -1
        call.spans.append(None)  # its place, filled when it closes
        rec._open.append(self.index)
        self.start_ns = time.perf_counter_ns()

    def __exit__(self, *exc) -> bool:
        rec = self.rec
        call = rec._call
        if self.index == 0:  # the root: its last step ends with it
            rec._end_step()
        call.spans[self.index] = (call.id, self.name, self.start_ns, time.perf_counter_ns(),
                                  self.parent)
        rec._open.pop()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        if not rec._open:  # the root closed: the call is done
            call.pending = None
            call.spans, call.stages = tuple(call.spans), tuple(call.stages)
            rec.calls.append(call)
            rec._call = None
        return False


MAX_CALLS = 4096  # the recorded calls kept


class Recorder:
    """The program's own spans, stage times and counters.

    Off by default: a public call checks ``forced`` and the profiler's flag
    and takes the plain path (``call`` returns ``OFF``; every ``span``,
    ``step`` and counter inside it does nothing). It is on inside ``tracing()`` and
    while a ``torch.profiler`` session runs, and then keeps the calls of
    the latest stretch in which it was on, the newest ``MAX_CALLS``.

    ``captures`` and ``replays`` count every program's captures and
    replays in the process, on or off, and ``meshset_builds`` every model's
    mesh-catalog builds; the byte counters count only the copies of recorded
    calls, in each call and in ``bytes`` (the stretch's totals), and the
    launch counters only their launches.
    """

    def __init__(self) -> None:
        self.forced = False
        self.calls: collections.deque = collections.deque(maxlen=MAX_CALLS)
        self.captures = 0
        self.replays = 0
        self.meshset_builds = 0
        self.bytes: dict = {}
        self._call: Call | None = None
        self._open: list[int] = []
        self._step: _Open | None = None  # the open step of the call
        self._ids = itertools.count()
        self._recording = False

    def _end_step(self) -> None:
        if self._step is not None:
            self._step.__exit__(None, None, None)
            self._step = None

    def clear(self) -> None:
        self.calls.clear()
        self.bytes.clear()

    def summary(self) -> dict:
        """Over the calls kept: ``calls``; ``spans``, by name, ``count`` and
        the ``mean_ms`` and ``self_ms`` (the duration less its children's)
        of one span; ``stages``, by name, the device ms a call (a stage that
        runs twice in a graph summed), over the calls whose stages were
        read; ``bytes``, by copy kind, the bytes a call; ``launches``, by
        counted wrapper, the launches a call; and the process's
        ``captures``, ``replays`` and ``meshset_builds``."""
        calls = list(self.calls)
        count, total, own = collections.Counter(), collections.Counter(), collections.Counter()
        stages, staged = collections.Counter(), 0
        copied, launched = collections.Counter(), collections.Counter()
        for call in calls:
            children = [0] * len(call.spans)
            for _, _, start, end, parent in call.spans:
                if parent >= 0:
                    children[parent] += end - start
            for (_, name, start, end, _), inner in zip(call.spans, children):
                count[name] += 1
                total[name] += end - start
                own[name] += end - start - inner
            for name, ms in call.stages:
                stages[name] += ms
            staged += bool(call.stages)
            copied.update(call.bytes)  # a Counter adds what a dict would replace
            launched.update(call.launches)
        return {
            "calls": len(calls),
            "spans": {n: {"count": c, "mean_ms": total[n] * 1e-6 / c, "self_ms": own[n] * 1e-6 / c}
                      for n, c in count.items()},
            "stages": {n: ms / staged for n, ms in stages.items()},
            "bytes": {k: b / len(calls) for k, b in copied.items()} if calls else {},
            "launches": {k: n / len(calls) for k, n in launched.items()} if calls else {},
            "captures": self.captures,
            "replays": self.replays,
            "meshset_builds": self.meshset_builds,
        }


RECORDER = Recorder()


def call(name: str):
    """The root span of a public call (``with profiling.call("track"):``):
    ``OFF`` unless the recorder is on. One thread at a time: the recorder
    keeps one open call."""
    rec = RECORDER
    if not (rec.forced or _autograd_profiler._is_profiler_enabled):
        rec._recording = False
        return OFF
    return _Open(rec, name)


def span(name: str):
    """A span of the current public call; ``OFF`` outside a recorded call."""
    return OFF if RECORDER._call is None else _Open(RECORDER, name)


def step(name: str) -> None:
    """Closes the current public call's open step and opens the span
    ``name``, a child of the call's root (the host's counterpart of
    ``programs.stage``); the root's end closes the last step. Nothing
    outside a recorded call."""
    rec = RECORDER
    if rec._call is not None:
        rec._end_step()
        rec._step = _Open(rec, name)
        rec._step.__enter__()


def counting() -> bool:
    """Whether a recorded call is open (its copies are counted)."""
    return RECORDER._call is not None


def count_bytes(kind: str, nbytes: int) -> None:
    """Adds ``nbytes`` of a copy of ``kind`` to the open recorded call and
    to the totals; nothing outside a recorded call."""
    call_ = RECORDER._call
    if call_ is not None and nbytes:
        call_.bytes[kind] = call_.bytes.get(kind, 0) + nbytes
        RECORDER.bytes[kind] = RECORDER.bytes.get(kind, 0) + nbytes


def count_launches(launches: dict) -> None:
    """Adds a graph replay's launches, by counted wrapper, to the open
    recorded call; nothing outside a recorded call."""
    call_ = RECORDER._call
    if call_ is not None:
        for name, n in launches.items():
            call_.launches[name] = call_.launches.get(name, 0) + n


def count_upload(src: torch.Tensor, dst: torch.Tensor) -> None:
    """Counts the host-to-device copy of ``src`` into ``dst``, pinned or
    pageable; none when ``dst`` is on the host (no upload took place)."""
    if RECORDER._call is not None and dst.device.type != "cpu":
        count_bytes("upload_pinned" if src.is_pinned() else "upload_pageable",
                    src.numel() * src.element_size())


def pending_stages(program) -> None:
    """Marks ``program``'s stage events, just replayed, as the open recorded
    call's to read after its readback (``read_stages``)."""
    if RECORDER._call is not None:
        RECORDER._call.pending = program


def read_stages() -> None:
    """After a recorded public call's readback (which waited for the
    device): the device ms of each stage of the graph it replayed, into the
    call."""
    call_ = RECORDER._call
    if call_ is not None and call_.pending is not None:
        program, call_.pending = call_.pending, None
        call_.stages.extend(program.stage_ms())


@contextlib.contextmanager
def tracing():
    """The operator's switch: the recorder is on inside the block, which
    starts a new stretch; yields the recorder (``summary()``)."""
    rec = RECORDER
    forced = rec.forced
    rec.clear()
    rec.forced, rec._recording = True, True
    try:
        yield rec
    finally:
        rec.forced, rec._recording = forced, False


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
