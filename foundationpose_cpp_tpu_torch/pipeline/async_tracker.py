"""Real-time async tracking session: capture thread -> frame ring -> card loop.

Counterpart of ``foundationpose_cpp_tpu.pipeline.async_tracker``. The
reference's EasyDeployTool provides an async_pipeline with IPipelinePackage
handoffs between stages (SURVEY.md SS2.8). Here a producer (camera, dataset
reader) pushes RGB-D frames into the port's native SPSC ring (C++,
drop-oldest), and the tracking loop consumes the NEWEST frame each
iteration: when the estimator is slower than the camera it skips stale
frames instead of lagging, and the ``dropped``/``skipped`` counters expose
the real-time behaviour.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Iterable

import numpy as np
import torch

from foundationpose_cpp_tpu_torch import native
from foundationpose_cpp_tpu_torch.pipeline.foundationpose import FoundationPose

PINNED_BUFFERS = 4  # host staging buffers a run cycles through on the card


@dataclasses.dataclass
class TrackRecord:
    frame_index: int
    pose: np.ndarray
    skipped_frames: int
    latency_s: float
    # host time spent issuing the (asynchronous) Track launches; the gap to
    # latency_s is the upload and the time in flight
    dispatch_s: float = 0.0


class _Uploader:
    """Pops the ring's newest frame and starts its copy to the model's device.

    On the card the frame lands in one of ``PINNED_BUFFERS`` pinned host
    buffers and goes up with a ``non_blocking`` copy on a side stream whose
    end is recorded in an event; a buffer is reused only once the event of
    its previous copy has completed, so no copy reads a buffer being
    refilled. On the CPU the popped array is the frame.
    """

    def __init__(self, ring: native.FrameRing, nbytes: int, device: torch.device):
        self._ring = ring
        self._nbytes = nbytes
        self._device = device
        if device.type == "cuda":
            self._stream = torch.cuda.Stream(device)
            self._pinned = [torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
                            for _ in range(PINNED_BUFFERS)]
            self._copied: list[torch.cuda.Event | None] = [None] * PINNED_BUFFERS
            self._next = 0

    def pop(self) -> tuple[torch.Tensor, "torch.cuda.Event | None", int] | None:
        """(frame as a uint8 tensor, event that ends its upload or None,
        frames skipped), or None when the ring is empty."""
        if self._device.type != "cuda":
            item = self._ring.pop_latest()
            return None if item is None else (torch.from_numpy(item[0]), None, item[1])
        i = self._next
        if self._copied[i] is not None:
            self._copied[i].synchronize()
        item = self._ring.pop_latest(out=self._pinned[i].numpy())
        if item is None:
            return None
        self._next = (i + 1) % PINNED_BUFFERS
        with torch.cuda.stream(self._stream):
            dev = torch.empty(self._nbytes, dtype=torch.uint8, device=self._device)
            dev.copy_(self._pinned[i], non_blocking=True)
            uploaded = torch.cuda.Event()
            uploaded.record(self._stream)
        self._copied[i] = uploaded
        return dev, uploaded, item[1]


class AsyncTracker:
    """Track an object through a live frame stream.

    Frames are (rgb u8 (H,W,3), depth (H,W)) pairs packed into one
    contiguous buffer for the ring (``FoundationPose.pack_frame``). The
    default wire format carries depth as uint16 millimeters (the
    sensor-native encoding the reference reads, help_func.hpp:10-52): H*W*5
    bytes per frame instead of H*W*7. depth_format="f32" keeps metric
    floats; rgb_half ships the colour plane at half resolution (see
    ``FoundationPose.make_packed_tracker``).
    """

    def __init__(
        self,
        model: FoundationPose,
        target_name: str,
        frame_hw: tuple[int, int],
        capacity: int = 4,
        refine_itr: int = 1,
        depth_format: str = "u16mm",
        rgb_half: bool = False,
    ) -> None:
        h, w = frame_hw
        self._model = model
        self._target = target_name
        self._hw = (h, w)
        self._refine_itr = refine_itr
        self._depth_format = depth_format
        self._rgb_half = bool(rgb_half)
        self._nbytes = FoundationPose.packed_frame_bytes(frame_hw, depth_format, rgb_half)
        self._ring = native.FrameRing((self._nbytes,), np.uint8, capacity)
        self._stop = threading.Event()
        self._frame_counter = 0
        self._packed_step = None  # the packed-frame Track, built on the first run
        self._uploader: threading.Thread | None = None

    def push_frame(self, rgb: np.ndarray, depth: np.ndarray) -> None:
        """Producer side (any thread). depth: f32 meters, or u16
        millimeters when the tracker runs the (default) u16mm format --
        sensor frames then pass through without conversion."""
        h, w = self._hw
        if rgb.shape != (h, w, 3) or rgb.dtype != np.uint8:
            raise ValueError(f"rgb must be u8 ({h},{w},3), got {rgb.dtype} {rgb.shape}")
        u16_ok = self._depth_format == "u16mm" and depth.dtype == np.uint16
        if depth.shape != (h, w) or (depth.dtype != np.float32 and not u16_ok):
            raise ValueError(
                f"depth must be f32 meters ({h},{w})"
                + (" or u16 millimeters" if self._depth_format == "u16mm" else "")
                + f", got {depth.dtype} {depth.shape}"
            )
        self._ring.push(
            FoundationPose.pack_frame(rgb, depth, self._depth_format, rgb_half=self._rgb_half)
        )
        self._frame_counter += 1

    def run(
        self,
        initial_pose: np.ndarray,
        on_pose: Callable[[TrackRecord], None] | None = None,
        max_frames: int | None = None,
        idle_sleep_s: float = 0.0005,
        pipeline_depth: int = 3,
    ) -> list[TrackRecord]:
        """Consumer loop: track until stop() or max_frames processed.

        Three overlapped stages:
          uploader thread: ring.pop_latest into a pinned buffer -> ONE
            asynchronous upload of the packed u8 frame on a side stream;
          this thread: its stream waits for the upload's event, then the
            packed-frame Track -- the pose stays a DEVICE tensor between
            frames, so no per-frame readback serializes the chain;
          readback: poses are read `pipeline_depth` frames behind the
            launch front (0 = fully synchronous).
        on_pose fires in frame order, `pipeline_depth` frames late. A model
        on the CPU runs the same loop with plain tensors.
        """
        if self._uploader is not None and self._uploader.is_alive():
            # a second consumer on the single-consumer ring would steal frames
            raise RuntimeError(
                "previous run()'s uploader has not exited; call stop() and "
                "wait for it before starting a new run"
            )
        if self._packed_step is None:
            self._packed_step = self._model.make_packed_tracker(
                self._target, self._hw, self._refine_itr,
                depth_format=self._depth_format, rgb_half=self._rgb_half,
            )
        step = self._packed_step
        device = self._model.device
        source = _Uploader(self._ring, self._nbytes, device)
        pose_dev = torch.as_tensor(np.asarray(initial_pose, dtype=np.float32), device=device)
        records: list[TrackRecord] = []
        staged: queue.Queue = queue.Queue(maxsize=2)
        done = object()
        # run-LOCAL stop flag: a wedged uploader from this run can never be
        # revived by a later run clearing the shared event (the shared
        # self._stop only carries the external stop() request)
        run_stop = threading.Event()

        def stopped() -> bool:
            return run_stop.is_set() or self._stop.is_set()

        def uploader() -> None:
            n = 0
            while not stopped() and (max_frames is None or n < max_frames):
                item = source.pop()
                if item is None:
                    # wait for the producer: a bounded run blocks until
                    # max_frames frames have arrived
                    time.sleep(idle_sleep_s)
                    continue
                t_cap = time.perf_counter()
                while not stopped():
                    try:
                        staged.put((*item, t_cap), timeout=0.2)
                        n += 1
                        break
                    except queue.Full:
                        continue
            while not stopped():
                try:
                    staged.put(done, timeout=0.2)
                    return
                except queue.Full:
                    continue

        up = threading.Thread(target=uploader, daemon=True)
        self._uploader = up
        up.start()
        pending: list[tuple[int, float, int, float, torch.Tensor]] = []
        processed = 0

        def complete(entry) -> None:
            idx, t_cap, skipped, disp, dev = entry
            rec = TrackRecord(
                frame_index=idx,
                pose=dev.cpu().numpy(),
                skipped_frames=skipped,
                latency_s=time.perf_counter() - t_cap,
                dispatch_s=disp,
            )
            records.append(rec)
            if on_pose is not None:
                on_pose(rec)

        try:
            while not self._stop.is_set():
                try:
                    item = staged.get(timeout=0.2)
                except queue.Empty:
                    continue
                if item is done:
                    break
                frame, uploaded, skipped, t_cap = item
                t0 = time.perf_counter()
                if uploaded is not None:
                    stream = torch.cuda.current_stream(device)
                    stream.wait_event(uploaded)
                    # the frame was allocated on the upload stream: keep its
                    # memory from reuse until this stream is done with it
                    frame.record_stream(stream)
                pose_dev = step(frame, pose_dev)
                disp = time.perf_counter() - t0
                pending.append((processed, t_cap, skipped, disp, pose_dev))
                processed += 1
                if len(pending) > max(0, pipeline_depth):
                    complete(pending.pop(0))
                if max_frames is not None and processed >= max_frames:
                    break
            for entry in pending:
                complete(entry)
            pending.clear()
        finally:
            run_stop.set()
            while True:  # unblock the uploader if it is mid-put
                try:
                    staged.get_nowait()
                except queue.Empty:
                    break
            up.join(timeout=2.0)
            # run_stop stays set, so even an uploader wedged past the join
            # timeout exits when it wakes instead of consuming the next
            # run's frames
            self._stop.clear()  # run() may be called again
        return records

    def stop(self) -> None:
        self._stop.set()

    @property
    def dropped_frames(self) -> int:
        return self._ring.dropped

    @property
    def pushed_frames(self) -> int:
        """Frames the producer has pushed (dropped + consumed + in-ring)."""
        return self._frame_counter

    def close(self) -> None:
        self._ring.close()


def track_dataset(
    model: FoundationPose,
    target_name: str,
    frames: Iterable[tuple[np.ndarray, np.ndarray]],
    initial_pose: np.ndarray,
    refine_itr: int = 1,
) -> list[np.ndarray]:
    """Synchronous helper mirroring the reference demo loop
    (test_foundationpose.cpp:75-104): each output pose feeds the next frame."""
    pose = np.asarray(initial_pose, dtype=np.float32)
    out = []
    for rgb, depth in frames:
        pose = model.track(rgb, depth, pose, target_name, refine_itr)
        out.append(pose)
    return out
