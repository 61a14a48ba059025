"""The benchmark of foundationpose_cpp_tpu_torch (see PERF.md)."""
