"""Metric aggregation, timing and logging utilities (port of
gaussreg_tpu/engine/summary.py).

reference: geotransformer/utils/summary_board.py:7-93,
average_meter.py:4-35, timer.py:4-79, engine/logger.py:6-53 and
common.py:46-71 (log string formatting). The process index is the
torch.distributed rank (0 when no process group is initialised).
"""

from __future__ import annotations

import logging
import sys
import time
from collections import deque
from typing import Dict, Optional


def process_index() -> int:
    """This process's rank in the default process group, else 0."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class AverageMeter:
    """Rolling / total average (reference average_meter.py:4-35)."""

    def __init__(self, last_n: Optional[int] = None):
        self._records = deque(maxlen=last_n)
        self._total = 0.0
        self._count = 0

    def update(self, value: float):
        self._records.append(float(value))
        self._total += float(value)
        self._count += 1

    @property
    def count(self):
        return self._count

    def sum(self):
        return self._total

    def mean(self):
        return self._total / max(self._count, 1)

    def smoothed(self):
        if not self._records:
            return 0.0
        return sum(self._records) / len(self._records)


class SummaryBoard:
    """Named meter collection (reference summary_board.py:7-93)."""

    def __init__(self, last_n: Optional[int] = None, adaptive: bool = True):
        self.meters: Dict[str, AverageMeter] = {}
        self.last_n = last_n
        self.adaptive = adaptive

    def update(self, name: str, value):
        if name not in self.meters:
            if not self.adaptive:
                raise KeyError(name)
            self.meters[name] = AverageMeter(self.last_n)
        self.meters[name].update(float(value))

    def update_from_dict(self, d: Dict):
        for k, v in d.items():
            try:
                self.update(k, float(v))
            except (TypeError, ValueError):
                pass

    def summary(self) -> Dict[str, float]:
        return {k: m.mean() for k, m in self.meters.items()}

    def smoothed_summary(self) -> Dict[str, float]:
        return {k: m.smoothed() for k, m in self.meters.items()}


def format_metrics(metrics: Dict[str, float]) -> str:
    """reference common.py:46-71."""
    return ", ".join(f"{k}: {v:.4g}" for k, v in metrics.items())


class Timer:
    """prepare/process timers (reference timer.py:4-45)."""

    def __init__(self):
        self._t = {}
        self._acc = {}
        self._n = {}

    def tic(self, key: str):
        self._t[key] = time.perf_counter()

    def toc(self, key: str):
        dt = time.perf_counter() - self._t[key]
        self._acc[key] = self._acc.get(key, 0.0) + dt
        self._n[key] = self._n.get(key, 0) + 1
        return dt

    def mean(self, key: str) -> float:
        return self._acc.get(key, 0.0) / max(self._n.get(key, 0), 1)


def get_logger(log_file: Optional[str] = None) -> logging.Logger:
    """Console (+ optional file) logger; only process 0 emits at INFO
    (reference engine/logger.py:6-53)."""
    logger = logging.getLogger("gaussreg")
    if logger.handlers:
        return logger
    level = logging.INFO if process_index() == 0 else logging.WARNING
    logger.setLevel(level)
    fmt = logging.Formatter("[%(asctime)s] [%(levelname)s] %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file and process_index() == 0:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class ScalarWriter:
    """TensorBoard scalar writer (rank-0 only), lazy import so headless
    environments work (reference base_trainer.py:59-61, 246-251)."""

    def __init__(self, log_dir: Optional[str]):
        self._writer = None
        if log_dir is None:
            return
        if process_index() != 0:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(log_dir)
        except Exception:
            self._writer = None

    def write(self, phase: str, metrics: Dict[str, float], step: int):
        if self._writer is None:
            return
        for k, v in metrics.items():
            self._writer.add_scalar(f"{phase}/{k}", v, step)

    def close(self):
        if self._writer is not None:
            self._writer.close()
