"""K2, the render kernel (csrc/render.cu: vertex_kernel, then
render_kernel), on a launch whose views each render their own mesh out of a
mesh table: its bound at this traffic's meshes and data (``counts_mixed``:
each distinct mesh's bytes once, each view's face-pixel tests against its
own mesh) over its kernel time in the traced slice, in percent."""

import re

KERNEL = re.compile(r"\b(vertex_kernel|render_kernel)\b")


def read(run):
    if run.trace is None or "k2_mixed_bound_s" not in run.work:
        return None
    spent = run.trace.kernel_s(KERNEL.search)
    return 100.0 * run.work["k2_mixed_bound_s"] * run.trace.calls / spent if spent > 0 else None
