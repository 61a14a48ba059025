"""Scripts that measure the port's kernels on the card."""
