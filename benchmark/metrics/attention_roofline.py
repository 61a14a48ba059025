"""K1, the attention kernel (csrc/attention.cu, mha_bf16_kernel): its bound
at this traffic's shapes (the benchmark's count of operations and bytes)
over its kernel time in the traced slice, in percent."""

import re

KERNEL = re.compile(r"\bmha_bf16_kernel\b")


def read(run):
    if run.trace is None or "k1_bound_s" not in run.work:
        return None
    spent = run.trace.kernel_s(KERNEL.search)
    return 100.0 * run.work["k1_bound_s"] * run.trace.calls / spent if spent > 0 else None
