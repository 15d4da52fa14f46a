"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller passes device="cpu" explicitly.
There is no silent CPU fallback: asking for (or defaulting to) CUDA on a
machine without it raises.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Return the torch.device to run on: `device` if given, else cuda.

    Raises RuntimeError when the result is a CUDA device and CUDA is not
    available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on the CPU"
        )
    return dev
