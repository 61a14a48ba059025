"""The bench's Track loops on the port of several checkouts, in turns, in one call.

    python -m foundationpose_cpp_tpu_torch.tools.bench_trees build/parent . . build/parent

Each argument is the root of a checkout ("." is this one). For each, in the
order given, a subprocess puts that checkout first on the import path and
runs this checkout's ``bench.py`` loops on the bench's scene (the
6016-face sphere at 480x640, seeded nets at the published widths):
``track_chained`` (256 chained ``track_step`` calls, ``track_fps``) and
``track_dispatch`` (64 packed-tracker steps on a frame already on the card,
``track_fps_dispatch``), three windows each. It prints one JSON line per
checkout and the card's name and power limit. ``bench.py`` is loaded by its
path, so an older checkout needs no bench of its own, only the modules that
``bench.py`` imports at its top. Unpack a commit to compare with
``git archive <commit> | tar -x -C build/parent``; two versions compare only
inside one call (parent, change, change, parent), since the host-bound
Track moves between machines.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1] / "bench.py"
WINDOWS = 3
CHILD = """
import importlib.util, json, sys
spec = importlib.util.spec_from_file_location("port_bench", sys.argv[2])
bench = importlib.util.module_from_spec(spec)
spec.loader.exec_module(bench)
ctx = bench.setup(None)
out = {"tree": sys.argv[1], "package": bench.fpp.__file__,
       "track_fps": [bench.track_chained(ctx, 256) for _ in range(int(sys.argv[3]))],
       "track_fps_dispatch": [bench.track_dispatch(ctx, 64) for _ in range(int(sys.argv[3]))]}
print(json.dumps(out), flush=True)
"""


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("trees", nargs="+", help="checkout roots, run in this order")
    args = ap.parse_args(argv)
    for tree in args.trees:
        root = str(pathlib.Path(tree).resolve())
        env = {**os.environ, "PYTHONPATH": root}
        proc = subprocess.run([sys.executable, "-c", CHILD, tree, str(BENCH), str(WINDOWS)],
                              env=env, cwd=root, check=True, capture_output=True, text=True)
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    from foundationpose_cpp_tpu_torch.bench import card_name_and_power_limit

    print(json.dumps({"card": card_name_and_power_limit()}), flush=True)


if __name__ == "__main__":
    main()
