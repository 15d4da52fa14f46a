"""K6 (csrc/segment_accumulate.cu), the per-gaussian accumulation, against its
roofline, in %: the least time the traced call's launches need
(portbench/counts_fine.py k6_counts, from the reference's pixel-gaussian
work of the call's views) over the device time of the kernel found by
symbol."""

from portbench import peaks


def read(trace):
    ms = trace.kernel_ms("accumulate_pairs_kernel")
    if not ms or "k6_bytes" not in trace.info:
        return None
    need = peaks.roofline_s(trace.info["k6_bytes"], trace.info["k6_bf16_flops"],
                            trace.info["k6_f32_flops"])
    return 100.0 * need / (ms / 1e3)
