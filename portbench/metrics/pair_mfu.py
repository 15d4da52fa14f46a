"""A pair's share of the dense bf16 peak, in %: the matrix products' operations
of the reference's forward on the traced pairs (torch's FlopCounterMode, at the
clouds' own sizes: backbone, transformer, patch scores and Sinkhorn) over the pair time of the window's untraced calls."""

from portbench import peaks


def read(trace):
    if "flops" not in trace.info or "call_s" not in trace.info:
        return None
    return 100.0 * trace.info["flops"] / (trace.info["call_s"] * peaks.BF16_FLOPS)
