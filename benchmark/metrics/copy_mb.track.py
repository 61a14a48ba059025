"""Megabytes (1e6 bytes) a Track call copies, as the program counts them:
the frame's and the poses' uploads, their loads into the graph's static
buffers, the output clones and the readback."""

from benchmark import program_trace


def read(run):
    return program_trace.copy_mb(run)
