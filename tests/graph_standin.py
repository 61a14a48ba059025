"""A stand-in for ``pipeline.programs.CudaGraphs`` on the CPU.

It runs the card's bookkeeping of a ``Program`` (static buffers, buffers
read in place, cloned outputs, launch counters, capture errors, stage
events) where there is no card. Its "replay" runs the function again on the static input
buffers and writes the results into the capture's output tensors, as a
replay of the graph would.

A real capture executes nothing. The stand-in's capture runs the function
to get the output tensors, so for a function that changes state (a training
step) it is given the optimizers whose parameters, gradients and state the
capture must leave as it found them: it copies them before the run and
writes them back after it.

``one_thread`` is a fixture for a test module to import: the module's
tests run with one intra-op thread.
"""

from __future__ import annotations

import contextlib
import time

import pytest
import torch

from foundationpose_cpp_tpu_torch.ops import cuda_build
from foundationpose_cpp_tpu_torch.pipeline import programs


class FakeGraph:
    """A captured 'graph': replay runs the function again on the static
    input buffers and writes the results into the capture's outputs."""

    def __init__(self, fn, inputs, outputs):
        self.fn, self.inputs, self.outputs = fn, inputs, outputs

    def replay(self):
        counts = cuda_build.launch_counts()  # a replay runs no wrapper
        new = self.fn(*self.inputs)
        for name, n in counts.items():
            cuda_build.COUNTERS[name].launches = n
        flat_new, flat_out = [], []
        programs.tree_map(flat_new.append, new)
        programs.tree_map(flat_out.append, self.outputs)
        for o, n in zip(flat_out, flat_new):
            o.copy_(n)


def _snapshot(opt: torch.optim.Optimizer) -> list:
    return [(p, p.detach().clone(), None if p.grad is None else p.grad.clone(),
             {k: v.clone() for k, v in opt.state[p].items() if isinstance(v, torch.Tensor)})
            for group in opt.param_groups for p in group["params"]]


def _restore(opt: torch.optim.Optimizer, saved: list) -> None:
    with torch.no_grad():
        for p, data, grad, state in saved:
            p.copy_(data)
            p.grad = grad
            for k, v in state.items():
                opt.state[p][k].copy_(v)


class FakeEvent:
    """A timing event on the host clock: ``record`` stamps it (at the
    capture, as the stand-in's replay runs no mark), ``elapsed_time`` is
    the milliseconds between two stamps."""

    def __init__(self):
        self.ms = None

    def record(self):
        self.ms = time.perf_counter() * 1e3

    def elapsed_time(self, end: "FakeEvent") -> float:
        return end.ms - self.ms


class FakeGraphs:
    """``programs.CudaGraphs``'s surface on the CPU. ``optimizers``: a list
    (filled by the caller, possibly after this is made) of the optimizers
    whose state a capture must leave as it found it."""

    def __init__(self, fail: bool = False, optimizers: list | None = None):
        self.captures, self.replays, self.fail = 0, 0, fail
        self.optimizers = [] if optimizers is None else optimizers

    def warm_up(self, fn, inputs):
        return fn(*inputs)

    def capture(self, fn, inputs, pool):
        self.captures += 1
        saved = [(opt, _snapshot(opt)) for opt in self.optimizers]
        outputs = fn(*inputs)
        for opt, state in saved:
            _restore(opt, state)
        if self.fail:
            raise RuntimeError("operation not permitted when stream is capturing")
        return FakeGraph(fn, inputs, outputs), outputs, 7

    def replay(self, graph):
        self.replays += 1
        graph.replay()

    @staticmethod
    def event():
        return FakeEvent()


@contextlib.contextmanager
def graphs(standin):
    """``programs.graphs_for`` returns ``standin`` (None: eager programs)
    inside the block."""
    saved = programs.graphs_for
    programs.graphs_for = lambda device: standin
    try:
        yield standin
    finally:
        programs.graphs_for = saved


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs files in parallel workers, where
    torch's default of a thread a core oversubscribes the machine and these
    small ops spend their time waiting for each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
