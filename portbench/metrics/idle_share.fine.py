"""The device's idle share of the traced fine calls, in %: 1 - busy / wall,
busy the union of the profiler's device operations."""


def read(trace):
    return 100.0 * (1.0 - trace.busy_s / trace.window_s) if trace.window_s > 0 else None
