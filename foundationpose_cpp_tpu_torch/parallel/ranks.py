"""The hypothesis split's ranks as processes of their own, on one host.

    python -m foundationpose_cpp_tpu_torch.parallel.ranks JOB_DIR RANK

``start`` writes a job (``job.json``: the mesh factory, intrinsics, config,
weight files and tasks; ``arrays.npz``: the frame, the padded grid, its
valid mask and the poses to track) into ``JOB_DIR`` and starts one
``python -m`` process for each rank, which meet through a ``file://``
rendezvous in the same directory; ``finish`` waits for them and reads what
each wrote. The ranks import the port alone, never JAX, and the process
that starts them joins no process group.

Each rank joins the group with ``sharding.make_hyp_group`` (``device``
None: the card ``cuda:{rank % device_count}``, so ranks share a card when
there are fewer cards than ranks) and runs every task:

- ``{"kind": "register", "scorer": NAME}``: ``make_sharded_register`` on the
  frame and the padded grid;
- ``{"kind": "track", "steps": S}``: ``make_sharded_track_batch`` chained S
  times from the poses.

On the card a task runs once to warm up (``warmup_collectives`` counts
its collectives). Then one counted run, for which the rank records the
launches of every counted kernel wrapper that launched
(``ops.cuda_build.COUNTERS``) and every ``torch.distributed`` collective
it issued; under NCCL that run is made under
``torch.cuda.set_sync_debug_mode("error")``, so that a step that waits for
the card raises. ``"reps": R`` times R more runs (host clock, the
card synchronised). Rank 0 then runs the single-process function
(``register_step`` with ``hyp_valid``, or ``track_step``) on the same
inputs as the reference (``ref_*`` arrays), timed likewise, while the
others wait.

At W=1 on the card the builders' functions are captured programs: the
warm-up runs the task and captures it (so it issues each collective
twice), and the counted run replays it, issuing no collective from Python.
Such a rank also runs the task with its programs called eagerly
(``eager_*`` arrays, ``eager_ms``) and records each program's key,
capture time and node count (``programs``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from foundationpose_cpp_tpu_torch.config import FoundationPoseConfig
from foundationpose_cpp_tpu_torch.meshio import procedural
from foundationpose_cpp_tpu_torch.models import convert_jax
from foundationpose_cpp_tpu_torch.ops import cuda_build
from foundationpose_cpp_tpu_torch.parallel import sharding
from foundationpose_cpp_tpu_torch.pipeline import programs
from foundationpose_cpp_tpu_torch.pipeline.foundationpose import register_step, track_step
from foundationpose_cpp_tpu_torch.pipeline.renderer import MeshConstants

PACKAGE_PARENT = pathlib.Path(__file__).resolve().parents[2]
# every collective and point-to-point call of torch.distributed, counted by
# name during a task's counted run (names this torch lacks are skipped)
COLLECTIVES = (
    "all_gather", "all_gather_into_tensor", "all_gather_object", "all_gather_single",
    "all_reduce", "all_to_all", "all_to_all_single", "barrier", "batch_isend_irecv",
    "broadcast", "broadcast_object_list", "gather", "gather_object", "irecv", "isend",
    "monitored_barrier", "recv", "reduce", "reduce_scatter", "reduce_scatter_tensor",
    "scatter", "scatter_object_list", "send",
)


@dataclasses.dataclass
class Launch:
    """Ranks started by ``start``."""

    workdir: pathlib.Path
    procs: list[subprocess.Popen]


def start(job: dict, arrays: dict[str, np.ndarray], world_size: int, workdir) -> Launch:
    """Write the job into the empty directory ``workdir`` and start its
    ``world_size`` ranks; each writes its log to ``rank{r}.log``."""
    workdir = pathlib.Path(workdir)
    job = dict(job, world_size=world_size, init_method=f"file://{workdir / 'rendezvous'}")
    (workdir / "job.json").write_text(json.dumps(job))
    np.savez(workdir / "arrays.npz", **arrays)
    env = dict(os.environ, LOCAL_WORLD_SIZE=str(world_size),
               PYTHONPATH=os.pathsep.join(filter(None, [str(PACKAGE_PARENT),
                                                        os.environ.get("PYTHONPATH")])))
    # every rank is on this host: rendezvous over the loopback interface
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    procs = []
    for rank in range(world_size):
        with open(workdir / f"rank{rank}.log", "wb") as logf:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "foundationpose_cpp_tpu_torch.parallel.ranks",
                 str(workdir), str(rank)],
                stdout=logf, stderr=subprocess.STDOUT, env=dict(env, LOCAL_RANK=str(rank)),
            ))
    return Launch(workdir, procs)


def finish(launch: Launch, timeout: float) -> list[dict]:
    """Wait for every rank (at most ``timeout`` seconds in all) and return
    each rank's ``{"meta": ..., "arrays": ...}``, in rank order. Raises
    RuntimeError, with the end of the logs, when a rank fails or time runs
    out; no rank outlives the call."""
    deadline = time.monotonic() + timeout
    try:
        # a rank that failed leaves the others waiting in a collective:
        # stop at the first failure
        while time.monotonic() < deadline:
            codes = [p.poll() for p in launch.procs]
            if all(c is not None for c in codes) or any(c for c in codes):
                break
            time.sleep(0.05)
    finally:
        for proc in launch.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    failed = [r for r, p in enumerate(launch.procs) if p.returncode != 0]
    if failed:
        tails = "\n".join(
            f"--- rank {r} (exit {launch.procs[r].returncode}):\n"
            + (launch.workdir / f"rank{r}.log").read_text(errors="replace")[-3000:]
            for r in failed)
        late = " (killed at the time limit)" if time.monotonic() >= deadline else ""
        raise RuntimeError(f"ranks {failed} of {len(launch.procs)} failed{late}:\n{tails}")
    out = []
    for r in range(len(launch.procs)):
        meta = json.loads((launch.workdir / f"rank{r}.json").read_text())
        with np.load(launch.workdir / f"rank{r}.npz") as data:
            out.append({"meta": meta, "arrays": dict(data)})
    return out


def run(job: dict, arrays: dict[str, np.ndarray], world_size: int, workdir,
        timeout: float = 600.0) -> list[dict]:
    """``start`` then ``finish``."""
    return finish(start(job, arrays, world_size, workdir), timeout)


@contextlib.contextmanager
def count_collectives():
    """Count the calls of every ``torch.distributed`` collective by name
    while the block runs."""
    counts = collections.Counter()
    saved = {name: getattr(dist, name) for name in COLLECTIVES if hasattr(dist, name)}

    def counted(name, fn):
        def call(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return call

    for name, fn in saved.items():
        setattr(dist, name, counted(name, fn))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


@contextlib.contextmanager
def no_host_sync(on: bool):
    """Raise on any operation that waits for the card while the block runs
    (when ``on``)."""
    if not on:
        yield
        return
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _timed(run, reps: int, device: torch.device):
    """(the last result, mean ms) of max(reps, 1) calls of run(), the card
    synchronised at the ends; the time is None when reps is 0."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(max(reps, 1)):
        out = run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, ((time.perf_counter() - t0) * 1e3 / reps if reps else None)


def _run_task(task: dict, hg: sharding.HypGroup, ctx: dict) -> tuple[dict, dict]:
    dev = hg.device
    mesh, K, cfg, data = ctx["mesh"], ctx["K"], ctx["cfg"], ctx["data"]
    if task["kind"] == "register":
        scorer = ctx["scorers"][task["scorer"]]
        args = (ctx["refiner"], scorer, data["rgb"], data["depth"], data["mask"],
                data["rot_grid"], data["hyp_valid"])
        sharded = sharding.make_sharded_register(mesh, hg, K, 1, cfg)

        def run():
            return sharded(*args)

        def reference():
            with torch.inference_mode():
                return register_step(mesh, *args[:6], K, 1, cfg, hyp_valid=args[6])
        names = ("best", "poses", "scores", "ok")
    else:
        steps = task.get("steps", 1)
        sharded = sharding.make_sharded_track_batch(mesh, hg, K, 1, cfg)

        def chain(step):
            poses = data["track_poses"]
            for _ in range(steps):
                poses = step(poses)
            return (poses,)

        def run():
            return chain(lambda p: sharded(ctx["refiner"], data["rgb"], data["depth"], p))

        def reference():
            with torch.inference_mode():
                return chain(lambda p: track_step(mesh, ctx["refiner"], data["rgb"],
                                                  data["depth"], p, K, 1, cfg))
        names = ("poses",)

    meta = {"kind": task["kind"]}
    if dev.type == "cuda":
        with count_collectives() as collectives:
            run()  # warm-up: cuDNN plans, the communicators, the captures
        meta["warmup_collectives"] = dict(collectives)
        torch.cuda.synchronize(dev)
    before = cuda_build.launch_counts()
    with count_collectives() as collectives, no_host_sync(hg.backend == "nccl"):
        got = run()
    meta.update(collectives=dict(collectives), launches=cuda_build.launches_since(before))
    arrays = {name: t.cpu().numpy() for name, t in zip(names, got)}
    reps = task.get("reps", 0)
    dist.barrier()
    if reps:
        meta["ms"] = _timed(run, reps, dev)[1]
    if dev.type == "cuda" and sharded.programs:
        meta["programs"] = [dict(key=list(p.key), capture_ms=p.capture_ms, nodes=p.nodes)
                            for p in sharded.programs.values()]
        with programs.eager():
            eager, meta["eager_ms"] = _timed(run, reps, dev)
        arrays.update({f"eager_{name}": t.cpu().numpy() for name, t in zip(names, eager)})
    if hg.rank == 0:
        if dev.type == "cuda":
            reference()
        ref, meta["ref_ms"] = _timed(reference, reps, dev)
        arrays.update({f"ref_{name}": t.cpu().numpy() for name, t in zip(names, ref)})
    dist.barrier()
    return meta, arrays


def main(workdir: str, rank: int) -> None:
    workdir = pathlib.Path(workdir)
    job = json.loads((workdir / "job.json").read_text())
    if job.get("threads"):
        torch.set_num_threads(job["threads"])
    hg = sharding.make_hyp_group(job["init_method"], rank, job["world_size"], job.get("device"))
    try:
        dev = hg.device
        cfg = FoundationPoseConfig(**job["cfg"])
        dtype = torch.bfloat16 if cfg.use_bf16_models else torch.float32
        factory, kwargs = job["mesh"]
        with np.load(workdir / "arrays.npz") as arrays:
            data = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
        ctx = dict(
            mesh=MeshConstants.from_asset(getattr(procedural, factory)(**kwargs), dev),
            K=torch.tensor(job["K"], dtype=torch.float32, device=dev), cfg=cfg, data=data,
            refiner=convert_jax.as_net(job["refiner"], "refiner", dev, dtype),
            scorers={name: convert_jax.as_net(path, "scorer", dev, dtype)
                     for name, path in job.get("scorers", {}).items()},
        )
        metas, out = [], {}
        for i, task in enumerate(job["tasks"]):
            meta, arrays = _run_task(task, hg, ctx)
            metas.append(meta)
            out.update({f"t{i}_{k}": v for k, v in arrays.items()})
        np.savez(workdir / f"rank{rank}.npz", **out)
        (workdir / f"rank{rank}.json").write_text(json.dumps({
            "rank": rank, "backend": hg.backend, "device": str(dev), "tasks": metas,
            "jax_imported": "jax" in sys.modules,
        }))
    finally:
        hg.close()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
