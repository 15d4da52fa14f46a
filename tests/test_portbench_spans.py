"""The benchmark's diagnostic of the program's spans (portbench/spans.py)
on a hand-made chrome trace of one coarse call, in the style of the stage
attribution's test; and the harness's own reduction of the same events,
which the program's spans leave as it was.

The call (times in us): `coarse_call` [0, 1000) holds the benchmark's
`pyramid` range [5, 360), in it the program's `pair_batch` [10, 300)
(`upload` [12, 40), `search.self.0` [50, 150)); then `partition`
[360, 400), `backbone` [400, 650) (the benchmark's hook range of the same
name [401, 599), `backbone.encoder1` [410, 500)), `LGR` [650, 700) and
`RANSAC` [700, 900). On the device: the pyramid's two kernels at [200, 250)
and [300, 330) with a ctypes kernel without correlation at [260, 280)
between them, partition's [380, 390), backbone's [500, 600), LGR's
[660, 670), RANSAC's [720, 730).
"""

import pytest

from portbench import spans, trace

BENCH_STAGES = ["pyramid", "backbone", "transformer", "partition", "matching", "sinkhorn",
                "LGR", "RANSAC"]


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _span(name, lo, hi):
    return _x("user_annotation", name, lo, hi - lo)


def _events(program=True):
    ranges = [_span("pyramid", 5, 360), _span("backbone", 401, 599)]  # the benchmark's
    if program:
        ranges += [_span("coarse_call", 0, 1000), _span("pair_batch", 10, 300),
                   _span("pair_batch.upload", 12, 40), _span("pair_batch.search.self.0", 50, 150),
                   _span("partition", 360, 400), _span("backbone", 400, 650),
                   _span("backbone.encoder1", 410, 500), _span("LGR", 650, 700),
                   _span("RANSAC", 700, 900)]
    host = [
        _x("cuda_runtime", "cudaLaunchKernel", 60, 2, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 280, 2, corr=2),
        _x("cuda_runtime", "cudaLaunchKernel", 365, 2, corr=3),
        _x("cuda_runtime", "cudaLaunchKernel", 420, 2, corr=4),
        _x("cuda_runtime", "cudaLaunchKernel", 655, 2, corr=5),
        _x("cuda_runtime", "cudaLaunchKernel", 710, 2, corr=6),
        # host waits: a blocking upload (an async copy, then its stream's sync)
        _x("cpu_op", "aten::to", 14, 21), _x("cpu_op", "aten::copy_", 16, 17),
        _x("cuda_runtime", "cudaMemcpyAsync", 18, 1, corr=7),
        _x("cuda_runtime", "cudaStreamSynchronize", 20, 5),
        _x("cpu_op", "aten::item", 110, 20), _x("cpu_op", "aten::_local_scalar_dense", 111, 18),
        _x("cuda_runtime", "cudaStreamSynchronize", 120, 5),
        _x("cuda_runtime", "cudaDeviceSynchronize", 340, 5),  # the benchmark's drain
        _x("cpu_op", "aten::copy_", 445, 15),
        _x("cuda_runtime", "cudaMemcpy", 450, 3),
        _x("cpu_op", "aten::nonzero", 790, 20),
        _x("cuda_runtime", "cudaStreamSynchronize", 800, 5),
        _x("cuda_runtime", "cudaDeviceSynchronize", 1100, 5),  # after the call
    ]
    device = [
        _x("kernel", "sort", 200, 50, corr=1),
        _x("kernel", "window_select_kernel", 260, 20),  # ctypes: no correlation
        _x("kernel", "gather", 300, 30, corr=2),
        _x("kernel", "partition", 380, 10, corr=3),
        _x("kernel", "kpconv_fused_kernel", 500, 100, corr=4),
        _x("kernel", "lgr", 660, 10, corr=5),
        _x("kernel", "ransac", 720, 10, corr=6),
    ]
    return ranges + host + device


def _trace(events, calls=2):
    return trace.reduce(events, BENCH_STAGES, calls, 0.002)


def _layers(events, calls):
    return {
        "pyramid_device": spans.device_ms(events, "pyramid", calls),
        "pyramid_idle": spans.idle_ms(events, "pyramid", calls),
        "backbone_idle": spans.idle_ms(events, "backbone", calls),
        "transformer_idle": spans.idle_ms(events, "transformer and matching", calls),
        "registration_idle": spans.idle_ms(events, "registration", calls),
        "host_waits": spans.host_waits(events, calls),
    }


def test_the_layers_on_a_hand_made_trace():
    # two calls: each number is half the trace's
    assert _layers(_events(), 2) == pytest.approx({
        "pyramid_device": (0.050 + 0.020 + 0.030) / 2,  # the ctypes kernel in
        "pyramid_idle": (0.010 + 0.020) / 2,  # not 330-380: the benchmark's drain
        "backbone_idle": 0.060 / 2,
        "transformer_idle": 0.110 / 2,
        "registration_idle": 0.050 / 2,
        "host_waits": 4 / 2,
    })


def test_host_waits_name_their_span_and_the_programs_op():
    assert spans.waits(_events()) == [
        ("pair_batch.upload", "aten::to"),
        ("pair_batch.search.self.0", "aten::item"),
        ("coarse_call", "-"),  # the benchmark's drain: listed, never counted
        ("backbone.encoder1", "aten::copy_"),
        ("RANSAC", "aten::nonzero"),
    ]
    report = spans.report(_events(), 1, 0.001)
    assert report["spans"]["pair_batch.search.self.0"] == pytest.approx(
        {"device_ms": 0.050, "idle_ms": 0.0, "waits": 1.0})
    assert report["layers"]["backbone"]["idle_ms"] == pytest.approx(0.060)
    assert report["host_waits"] == 4
    assert (report["wall_ms"], report["busy_ms"]) == pytest.approx((1.0, 0.230))


def test_the_layers_find_nothing_without_the_programs_spans():
    """A program without spans (the parent of these spans) reads None, and
    raises nothing."""
    for events in (_events(program=False), []):
        assert set(_layers(events, 1).values()) == {None}


def test_the_diagnostic_keeps_the_events_the_runner_reduces():
    """`spans.traced` returns the runner's own Trace and the events its
    profile reduced, and puts `trace.reduce` back."""
    events = _events()
    reduce = trace.reduce

    class Runner:
        def traced(self):
            return trace.reduce(events, BENCH_STAGES, 1, 0.001)

    tr, kept = spans.traced(Runner())
    assert kept is events
    assert tr.stage_ms == _trace(events, calls=1).stage_ms
    assert trace.reduce is reduce


@pytest.mark.parametrize("program", [False, True])
def test_the_programs_spans_leave_the_reduced_trace_as_it_was(program):
    """stage_ms, busy_s and the breakdown are what the hand-made trace
    gives, the program's spans present or not (those that share a
    benchmark stage's name cover the same launches)."""
    t = _trace(_events(program), calls=1)
    assert t.busy_s == pytest.approx(230e-6)
    assert t.stage_ms == pytest.approx({"pyramid": 0.100, "partition": 0.010,
                                        "backbone": 0.100, "LGR": 0.010, "RANSAC": 0.010}
                                       if program else {"pyramid": 0.100, "backbone": 0.100})
    assert t.breakdown["device_ops"][0] == ["kpconv_fused_kernel", pytest.approx(1e-4)]
    gaps = dict(t.breakdown["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx(300e-6)
    assert gaps["pyramid"] == pytest.approx(80e-6)  # 250-260, 280-300, 330-380
