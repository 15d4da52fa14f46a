"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit). A run records the card's
`power.limit` beside any share of these."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12  # tensor cores, dense
F32_FLOPS = 67e12  # outside the tensor cores


def roofline_s(bytes_moved: float, bf16_flops: float = 0.0, f32_flops: float = 0.0) -> float:
    """The least time the card could take: the larger of the bytes at the
    memory's peak and the operations, each type at its peak."""
    return max(bytes_moved / HBM_BYTES_PER_S, bf16_flops / BF16_FLOPS + f32_flops / F32_FLOPS)


def power_limit() -> str:
    """`nvidia-smi`'s name and power limit of the card, or '' without it."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else ""
