"""K2, the render kernel (csrc/render.cu: vertex_kernel, then
render_kernel): its bound at this traffic's shapes and data (the
benchmark's count of bytes and face-pixel tests) over its kernel time in
the traced slice, in percent."""

import re

KERNEL = re.compile(r"\b(vertex_kernel|render_kernel)\b")


def read(run):
    if run.trace is None or "k2_bound_s" not in run.work:
        return None
    spent = run.trace.kernel_s(KERNEL.search)
    return 100.0 * run.work["k2_bound_s"] * run.trace.calls / spent if spent > 0 else None
