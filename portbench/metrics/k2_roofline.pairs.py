"""K2 (csrc/kpconv_fused.cu) against its roofline, in %: the least time a pair's
KPConv contractions need (portbench/counts.py k2_counts, from the reference's
influences) over the device time of the kernel found by symbol."""

from portbench import peaks


def read(trace):
    ms = trace.kernel_ms("kpconv_fused_kernel")
    if not ms or "k2_bytes" not in trace.info:
        return None
    need = peaks.roofline_s(trace.info["k2_bytes"], trace.info["k2_bf16_flops"],
                            trace.info["k2_f32_flops"])
    return 100.0 * need / (ms / 1e3 / trace.calls)
