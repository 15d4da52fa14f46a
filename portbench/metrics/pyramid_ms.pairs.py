"""Host ms a pair in the pyramid (data/pipeline.py, ops/subsample.py, ops/neighbors.py,
ops/fused_select.py): the host clock around `make_pair_batch`, from a device sync
before it to one after it, wrapped from outside, averaged over the traced pairs."""


def read(trace):
    spans = trace.host_s.get("pyramid")
    return 1e3 * sum(spans) / len(spans) if spans else None
