"""Generic training loops: epoch-based and iteration-based (port of
gaussreg_tpu/engine/loops.py).

reference: geotransformer/engine/epoch_based_trainer.py:82-181 and
iter_based_trainer.py:17-200 (CycleLoader + iteration loop with periodic
validation). The loops stay thin: they drive the train/eval steps, metric
boards, and checkpointing.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, Iterable, Optional

from gaussreg_tpu_torch.engine.summary import SummaryBoard, Timer


def cycle_loader(make_iter: Callable[[int], Iterable]):
    """Infinite iterator cycling over epochs of a data source
    (reference iter_based_trainer.py:17-36 CycleLoader)."""
    for epoch in itertools.count():
        yielded = False
        for item in make_iter(epoch):
            yielded = True
            yield epoch, item
        if not yielded:
            raise ValueError("empty data iterator")


def run_iterations(
    state,
    data_iter,
    step_fn: Callable,
    max_iterations: int,
    *,
    log_steps: int = 10,
    snapshot_steps: Optional[int] = None,
    on_log: Optional[Callable[[int, Dict], None]] = None,
    on_snapshot: Optional[Callable[[int, object], None]] = None,
):
    """Iteration-based training (reference iter_based_trainer.py:139-200):
    run `max_iterations` steps of `step_fn(state, batch) -> (state, metrics)`
    with periodic logging and snapshot callbacks. Returns the final state."""
    board = SummaryBoard(last_n=log_steps)
    timer = Timer()
    for it in range(max_iterations):
        timer.tic("prepare")
        _, batch = next(data_iter)
        timer.toc("prepare")
        timer.tic("process")
        state, metrics = step_fn(state, batch)
        timer.toc("process")
        board.update_from_dict({k: float(v) for k, v in metrics.items()})
        if on_log is not None and (it + 1) % log_steps == 0:
            on_log(it + 1, board.smoothed_summary())
        if (
            on_snapshot is not None
            and snapshot_steps
            and (it + 1) % snapshot_steps == 0
        ):
            on_snapshot(it + 1, state)
    return state
