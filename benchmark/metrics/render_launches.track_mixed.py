"""Launches of K2's wrapper (``render_views``: its vertex pass and its
render kernel) a call, as the program counts them in the traced slice's
calls (the recorder's launch counters, ``programs.COUNTED``): one a
refinement when one launch renders every object's view. Nothing where the
program keeps no launch counts."""

from benchmark import program_trace


def read(run):
    s = program_trace.summary(run)
    if s is None:
        return None
    return s.get("launches", {}).get("render_views")
