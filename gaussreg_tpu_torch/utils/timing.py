"""Device time of a short launch on a CUDA card, without the host's time
between launches."""

from __future__ import annotations

import torch


def slope(fn, r_lo: int = 4, r_hi: int = 16, n_meas: int = 3) -> float:
    """Seconds per call of fn(i) on the card: CUDA graphs of r_lo and r_hi
    calls fn(0), fn(1), ... (the caller perturbs its inputs by i), each
    replayed n_meas times and timed with CUDA events; the slope between the
    fastest replays. A graph launches its kernels back to back, so no host
    time between launches is counted, and the slope drops the replay's
    fixed cost. What remains of a call is its kernels and the device's gap
    between two kernels of a graph."""
    for i in range(3):  # builds, loads and sets kernel attributes outside capture
        fn(i)
    torch.cuda.synchronize()
    graphs = {}
    for r in (r_lo, r_hi):
        graph = torch.cuda.CUDAGraph()
        # relaxed: a launcher may set a kernel attribute while being captured
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            for i in range(r):
                fn(i)
        graph.replay()
        graphs[r] = graph
    torch.cuda.synchronize()

    def meas(r):
        best = float("inf")
        for _ in range(n_meas):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graphs[r].replay()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        return best

    return (meas(r_hi) - meas(r_lo)) / (r_hi - r_lo)
