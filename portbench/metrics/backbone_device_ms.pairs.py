"""Device ms a pair in the backbone (models/kpconv.py, models/backbone.py): device
time in the backbone forward's window, over the traced pairs."""


def read(trace):
    ms = trace.stage_ms.get("backbone")
    return ms / trace.calls if ms is not None else None
