"""Compiled programs: the port's ``jax.jit`` and executable cache.

The JAX package never runs its entry points op by op: each is one compiled
program, cached under a key (``FoundationPose._register_cache`` /
``_track_cache``, ``XlaInferCore._jitted``) and called again. A ``Program``
is the counterpart on the card: a function over tensors captured once as a
CUDA graph and replayed.

On a CUDA device the first call

1. copies its arguments into static input buffers (an argument listed in
   ``buffers`` is the caller's own persistent buffer and is read in place);
2. runs the function once on the capture stream: this lets cuDNN and cuBLAS
   pick their plans and make their handles, ``transforms._constant`` build
   its constants and the kernels set their attributes, all outside the
   capture, and its result is the call's result;
3. captures the function on the same stream into a ``torch.cuda.CUDAGraph``
   (in the model's memory pool when one is given).

Every later call copies its arguments into the static buffers (a buffer
given again is not copied), replays the graph, and returns clones of the
graph's outputs: an output never aliases graph memory, so a result held
while later calls run (``AsyncTracker``'s pending poses) keeps its value.
A replay makes no host synchronization when its arguments are on the card.

A capture or a replay that fails raises RuntimeError with the program's key:
there is no eager fallback on the card. On the CPU a Program calls its
function eagerly, because the caller chose that device.

Launch counters: the kernels' wrappers count their launches in Python
(``render_views.launches`` ...; the registry ``ops.cuda_build.COUNTERS``),
which a replay does not run. A Program records each counter's increase
during its capture, by the wrapper's name, takes it back (the
capture launched nothing) and adds it on every replay, so a counter counts
the kernel launches the card made: one call's worth on the first call (the
run before the capture) and on each replay. A recorded public call
(``utils.profiling``) also keeps the launches its programs' replays made.

Stage events: the function marks its stages with ``stage(name)``. During
the capture of a ``staged`` Program each mark records a timing event into
the graph (an event node), and the Program records one more after the
function, which closes the last stage; elsewhere (the CPU, ``eager()``,
the warm-up run, an unstaged Program's capture) a mark does nothing, so a
replay computes what the eager function computes. After a replay the
device ms between consecutive events are the stages' times
(``stage_ms``); a public call reads them into ``utils.profiling``'s
recorder after its readback, while the recorder is on. ``captures`` and
``replays`` count a Program's captures and replays.

Everything a graph reads is captured by address: the static buffers, the
nets' parameters, the meshes' tensors and the model's constants.
``load_state_dict`` copies in place and is safe; replacing a module or a
tensor the function reads after the capture is not. A Program serves one
caller at a time: two threads calling it at once would share its buffers.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import gc
import time
from typing import Any, Callable, Iterable

import torch

from foundationpose_cpp_tpu_torch.ops import cuda_build
from foundationpose_cpp_tpu_torch.utils import profiling


# (the stage marks of the Program being captured, its event factory) during
# a capture, else None
_capturing: tuple[list, Callable] | None = None


def stage(name: str) -> None:
    """Opens the stage ``name`` of the function being captured and closes
    the stage before it: records a timing event into the graph. Does
    nothing outside a Program's capture."""
    if _capturing is not None:
        marks, event = _capturing
        marks.append((name, event()))
        marks[-1][1].record()


def _add_launches(launches: dict[str, int]) -> None:
    """Adds ``launches`` (by counted wrapper's name) to the counters."""
    for name, n in launches.items():
        cuda_build.COUNTERS[name].launches += n


def tree_map(fn: Callable[[torch.Tensor], Any], tree):
    """``fn`` on every tensor of a tensor, a tuple / list or a dict of them."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def _node_count(graph: torch.cuda.CUDAGraph) -> int | None:
    """Nodes of a captured graph that kept its cudaGraph_t
    (``cuGraphGetNodes`` from libcuda), None when that call fails."""
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    n = ctypes.c_size_t(0)
    err = lib.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    return int(n.value) if err == 0 else None


class CudaGraphs:
    """The CUDA side of a Program on one device: its warm-up run and its
    capture on one capture stream, its replay on the current stream."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.stream = torch.cuda.Stream(device)

    def warm_up(self, fn: Callable, inputs: list[torch.Tensor]):
        """fn(*inputs) on the capture stream, after the current stream's
        work (the inputs' copies); its tensors may be used on the current
        stream."""
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            result = fn(*inputs)
        current.wait_stream(self.stream)
        tree_map(lambda t: t.record_stream(current), result)
        return result

    def capture(self, fn: Callable, inputs: list[torch.Tensor], pool):
        """(graph, fn's outputs in graph memory, the graph's node count).

        Python's garbage collector is run first and kept off during the
        capture: a collection inside it could destroy another graph (one of
        an unreachable model), whose memory release is not allowed while a
        stream captures and would invalidate this capture."""
        graph = torch.cuda.CUDAGraph(keep_graph=True)  # kept for its node count
        gc.collect()
        enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool, stream=self.stream):
                outputs = fn(*inputs)
        finally:
            if enabled:
                gc.enable()
        graph.instantiate()
        torch.cuda.current_stream(self.device).wait_stream(self.stream)
        return graph, outputs, _node_count(graph)

    @staticmethod
    def replay(graph) -> None:
        graph.replay()

    @staticmethod
    def event() -> torch.cuda.Event:
        """A timing event that a capture records as a node of the graph."""
        return torch.cuda.Event(enable_timing=True, external=True)


@functools.cache
def graphs_for(device: torch.device) -> CudaGraphs | None:
    """The graph backend of ``device``: CUDA graphs on a CUDA device, None
    (eager calls) elsewhere."""
    return CudaGraphs(device) if device.type == "cuda" else None


@contextlib.contextmanager
def eager():
    """Every Program calls its function eagerly while the block runs, on
    the card too: the reference that a replay is held against."""
    global graphs_for
    saved = graphs_for
    graphs_for = lambda device: None  # noqa: E731
    try:
        yield
    finally:
        graphs_for = saved


class Program:
    """``fn(*args)`` over tensors, captured once as a CUDA graph on a CUDA
    ``device`` and replayed on every later call; called eagerly on the CPU.

    key: the cache key the program serves, named in every error. pool: a
    memory pool (``torch.cuda.graph_pool_handle()``) shared with the owner's
    other programs, which is safe because their replays run in order on one
    stream and each call's outputs are cloned before the next replay; None
    gives the graph a pool of its own. buffers: positions of arguments that
    are the caller's persistent device buffers (a size bucket's frame): the
    graph reads them in place, and a call that passes another tensor there
    copies it in. staged: the capture records ``fn``'s stage marks as
    event nodes, for a caller that reads them back (``stage_ms``); the
    marks of an unstaged program do nothing, so its graph carries no
    event node.

    After the capture: ``capture_ms`` (host clock, the warm-up run
    excluded), ``nodes`` (the graph's node count, or None),
    ``launches_per_call`` (each counted wrapper's launches in one replay)
    and ``stages`` (the names of the stages marked in the graph, in order).
    ``captures`` and ``replays`` count always.
    """

    def __init__(self, fn: Callable, key: tuple, device, *, pool=None,
                 buffers: Iterable[int] = (), staged: bool = False) -> None:
        self.fn = fn
        self.key = key
        self.device = torch.device(device)
        self.staged = staged
        self._pool = pool
        self._buffers = frozenset(buffers)
        self._graph = None
        self._inputs: list[torch.Tensor] = []
        self._outputs = None
        self._delta: dict[str, int] = {}
        self._marks: list[tuple[str | None, Any]] = []  # (stage, event), the end's name None
        self.capture_ms: float | None = None
        self.nodes: int | None = None
        self.captures = 0
        self.replays = 0

    @property
    def captured(self) -> bool:
        return self._graph is not None

    @property
    def launches_per_call(self) -> dict[str, int]:
        return dict(self._delta)

    @property
    def stages(self) -> list[str]:
        return [name for name, _ in self._marks[:-1]]

    def stage_ms(self) -> list[tuple[str, float]]:
        """(stage, device ms) of each stage of the latest replay, in the
        graph's order; read it once the device has run the replay."""
        return [(name, start.elapsed_time(end))
                for (name, start), (_, end) in zip(self._marks, self._marks[1:])]

    def __call__(self, *args: torch.Tensor):
        graphs = graphs_for(self.device)
        if graphs is None:
            return self.fn(*args)
        if self._graph is None:
            return self._capture(graphs, args)
        with profiling.span("load"):
            self._load(args)
        with profiling.span("replay"):
            try:
                graphs.replay(self._graph)
            except RuntimeError as exc:
                raise RuntimeError(
                    f"program {self.key!r}: CUDA graph replay failed: {exc}") from exc
        self.replays += 1
        profiling.RECORDER.replays += 1
        _add_launches(self._delta)
        if profiling.counting():
            profiling.count_launches(self.launches_per_call)
        if self._marks:
            profiling.pending_stages(self)
        with profiling.span("clone"):
            out = tree_map(torch.clone, self._outputs)
            if profiling.counting():
                sizes = []
                tree_map(lambda t: sizes.append(t.numel() * t.element_size()), out)
                profiling.count_bytes("clone", sum(sizes))
        return out

    def _closed(self, *inputs: torch.Tensor):
        """The function as captured: a last event closes its last stage."""
        outputs = self.fn(*inputs)
        if self._marks:
            stage(None)
        return outputs

    def _load(self, args) -> None:
        counted = profiling.counting()
        if len(args) != len(self._inputs):
            raise ValueError(f"program {self.key!r}: {len(args)} arguments, captured with "
                             f"{len(self._inputs)}")
        for i, (buf, arg) in enumerate(zip(self._inputs, args)):
            if arg.shape != buf.shape or arg.dtype != buf.dtype:
                raise ValueError(
                    f"program {self.key!r}: argument {i} is {arg.dtype} {tuple(arg.shape)}, "
                    f"captured as {buf.dtype} {tuple(buf.shape)}")
            if not (arg.device == buf.device and arg.data_ptr() == buf.data_ptr()
                    and arg.stride() == buf.stride()):
                buf.copy_(arg)
                if counted:
                    profiling.count_bytes("load", buf.numel() * buf.element_size())

    def _capture(self, graphs: CudaGraphs, args):
        global _capturing
        inputs = []
        for i, arg in enumerate(args):
            if i in self._buffers and arg.device == self.device and arg.is_contiguous():
                inputs.append(arg)
            else:
                buf = torch.empty(arg.shape, dtype=arg.dtype, device=self.device)
                buf.copy_(arg)
                profiling.count_bytes("load", buf.numel() * buf.element_size())
                inputs.append(buf)
        result = graphs.warm_up(self.fn, inputs)  # the warm-up run: this call's result
        before = cuda_build.launch_counts()
        t0 = time.perf_counter()
        self._marks = []
        if self.staged:
            _capturing = (self._marks, graphs.event)
        try:
            graph, outputs, nodes = graphs.capture(self._closed, inputs, self._pool)
        except Exception as exc:
            raise RuntimeError(
                f"program {self.key!r}: CUDA graph capture failed: {exc}") from exc
        finally:
            _capturing = None
            delta = cuda_build.launches_since(before)
            # the capture recorded the launches and made none
            _add_launches({name: -n for name, n in delta.items()})
        self.captures += 1
        profiling.RECORDER.captures += 1
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self._graph, self._inputs, self._outputs = graph, inputs, outputs
        self._delta, self.nodes = delta, nodes
        return result
