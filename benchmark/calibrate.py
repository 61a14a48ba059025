"""Readings that a cell's limits are set from; not run by the benchmark's
own runs.

    python3 -m benchmark.calibrate --workload register.scan13k --seconds 3 \
        --seeds 11 12 13 ... --control-seeds 21 22 23

In one process, at the cell's own sizes: for each of ``--seeds`` the
program (one model, its programs captured once) through a short window of
the cell's traffic and the check against the plain reference; for each of
``--control-seeds`` each of ``--controls``, the reference in the program's
place one precision below what the configuration states, through the same
check:

  fp8_nets       the nets' operands in float8 e4m3 (the nets are bfloat16)
  bf16_geometry  the geometry's results in bfloat16 (it is float32)
  tf32           TF32 on in every float32 product (it is off)

Prints one JSON line per reading and, last, each number's lower reading
(the largest over the program's seeds) and its upper reading under each
control (the smallest over the control's seeds).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

from benchmark import harness
from benchmark.reference import geometry, nets

CONTROLS = {
    "fp8_nets": {"quant": nets.fp8_e4m3},
    "bf16_geometry": {"geom": geometry.bf16},
    "tf32": {},
}


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 in cuBLAS and cuDNN products while the block runs."""
    import torch

    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def readings(cell: str, seeds, control_seeds, seconds: float, device: str = "cuda",
             root=harness.HERE, out=print, controls=tuple(CONTROLS)) -> dict:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    wl = harness.load_json(root / "workloads" / f"{cell}.json")
    config = harness.load_json(root / "configs" / f"{wl['config']}.json")
    kind = harness.load_module(root / "traffic" / f"{wl['traffic']}.py", f"fpbench_cal_{cell}")
    dev = torch.device(device)
    model, lower, upper = None, {}, {}
    for seed in seeds:
        traffic = kind.Traffic(wl, config, seed, dev, root)
        traffic.make_inputs()
        model = model or traffic.build_model()
        traffic.warm_up(model)
        start, i = time.perf_counter(), 0
        while time.perf_counter() - start < seconds:
            traffic.call(model, i)
            i += 1
        checks = traffic.check(traffic.program_outputs(model), traffic.reference())
        out(json.dumps({"cell": cell, "who": "program", "seed": seed, "calls": i,
                        "checks": {k: c["value"] for k, c in checks.items()}}))
        for k, c in checks.items():
            lower[k] = max(lower.get(k, float("-inf")), c["value"])
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    for seed in control_seeds:
        traffic = kind.Traffic(wl, config, seed, dev, root)
        traffic.make_inputs()
        ref = traffic.reference()
        for control in controls:
            low = traffic.reference(**CONTROLS[control])
            with tf32(control == "tf32"):
                got = traffic.control_outputs(low)
            del low
            checks = traffic.check(got, ref)
            out(json.dumps({"cell": cell, "who": control, "seed": seed,
                            "checks": {k: c["value"] for k, c in checks.items()}}))
            for k, c in checks.items():
                upper.setdefault(k, {})
                upper[k][control] = min(upper[k].get(control, float("inf")), c["value"])
    summary = {k: {"lower": lower.get(k), "upper": upper.get(k, {}),
                   "limit": wl["limits"][k]} for k in wl["limits"]}
    out(json.dumps({"cell": cell, "summary": summary}))
    return summary


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--controls", nargs="*", choices=sorted(CONTROLS),
                        default=list(CONTROLS))
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    readings(args.workload, args.seeds, args.control_seeds, args.seconds,
             controls=args.controls)
    return 0


if __name__ == "__main__":
    sys.exit(main())
