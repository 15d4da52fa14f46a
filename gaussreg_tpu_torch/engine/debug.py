"""Debug and observability switches (port of gaussreg_tpu/engine/debug.py).

reference: geotransformer/utils/torch.py:83-94 (seeding, autograd anomaly
detection) and engine/base_trainer.py:219-227 (the NaN/Inf gradient
check, which engine/trainer.py's step does by skipping the update).
"""

from __future__ import annotations

import contextlib
import os

import torch


def enable_anomaly_detection(nans: bool = True) -> None:
    """Fail fast, with the traceback of the forward op at fault, when a
    backward produces a NaN (torch.autograd.set_detect_anomaly; `nans=False`
    turns it off). torch's anomaly mode detects NaN only: the JAX package's
    `infs` switch has no counterpart here. Expensive: for debugging."""
    torch.autograd.set_detect_anomaly(nans)


def seed_everything(seed: int) -> torch.Generator:
    """Seed Python's, numpy's and torch's global generators, and return a
    CPU torch.Generator seeded with `seed` for the randomness that the
    port threads explicitly (initialisation, GT sampling, RANSAC)."""
    import random

    import numpy as np

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """torch.profiler over the block, CPU and (when present) CUDA
    activity, written as a Chrome/Perfetto trace into `log_dir`."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


_NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """The program's one way to open a named span: a
    torch.profiler.record_function range while a profiler records (so that
    the span lands in the same trace as the device's events), else a
    shared null context. The gate costs ~0.1 us; a record_function costs
    ~10 us even with no profiler running."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN
