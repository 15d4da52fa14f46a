"""Device ms a pair in the transformer and matching (models/transformer.py,
models/geotransformer.py, models/matching.py, ops/sinkhorn.py, ops/partition.py):
the device time of the partition, transformer, superpoint matching and Sinkhorn
stages, over the traced pairs."""

STAGES = ("partition", "transformer", "matching", "sinkhorn")


def read(trace):
    hits = [trace.stage_ms[s] for s in STAGES if s in trace.stage_ms]
    return sum(hits) / trace.calls if hits else None
