"""Seconds from the process's start to the first timed call: imports, the
kernels' load (their build on a checkout's first run), the checkpoints,
the mesh, the frames, the warm-up calls and the graphs' capture."""


def read(run):
    return run.setup_s
