"""Host ms a call in the fine loop's capacity probes
(gs/fine_registration.py `_probe_caps`): the host clock around each probe,
from a device sync before it to one after it, wrapped from outside, summed
over the traced calls' probes, over the calls."""


def read(trace):
    spans = trace.host_s.get("probe")
    return 1e3 * sum(spans) / trace.calls if spans else None
