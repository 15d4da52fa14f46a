"""K1 (csrc/window_select.cu) against its roofline, in %: the least time the
traced pairs' 13 radius searches need (portbench/counts.py k1_counts, from the
reference's pyramid) over the device time of the kernel found by symbol."""

from portbench import peaks


def read(trace):
    ms = trace.kernel_ms("window_select_kernel")
    if not ms or "k1_bytes" not in trace.info:
        return None
    need = peaks.roofline_s(trace.info["k1_bytes"], trace.info["k1_bf16_flops"],
                            trace.info["k1_f32_flops"])
    return 100.0 * need / (ms / 1e3 / trace.calls)
