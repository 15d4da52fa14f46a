"""Host ms a call in register_gs_pair's front end (gs/extract.py: both .ply
files read, the clouds extracted and sampled down by the host FPS, the
volume normalisation): the host clock around `load_point_cloud_from_gs_ply`
and `adjust_point_cloud_volume`, syncs at both ends, wrapped from outside,
summed over the traced calls, over the calls."""


def read(trace):
    spans = trace.host_s.get("front_end")
    return 1e3 * sum(spans) / trace.calls if spans else None
