"""K5 (csrc/rasterize_bwd.cu), the tile backward, against its
roofline, in %: the least time the traced call's launches need
(portbench/counts_fine.py k5_counts, from the reference's pixel-gaussian
work of the call's views) over the device time of the kernel found by
symbol."""

from portbench import peaks


def read(trace):
    ms = trace.kernel_ms("rasterize_bwd_kernel")
    if not ms or "k5_bytes" not in trace.info:
        return None
    need = peaks.roofline_s(trace.info["k5_bytes"], trace.info["k5_bf16_flops"],
                            trace.info["k5_f32_flops"])
    return 100.0 * need / (ms / 1e3)
