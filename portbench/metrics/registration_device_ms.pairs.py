"""Device ms a pair in registration (LGR in models/matching.py, ops/procrustes.py,
ops/ransac.py): the device time of the LGR and RANSAC stages, over the traced
pairs."""


def read(trace):
    hits = [trace.stage_ms[s] for s in ("LGR", "RANSAC") if s in trace.stage_ms]
    return sum(hits) / trace.calls if hits else None
