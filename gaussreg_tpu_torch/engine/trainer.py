"""Training engine: the optimizer, the train and eval steps (port of
gaussreg_tpu/engine/trainer.py).

The optimizer reproduces the JAX package's optax chain, not a nearby
variant: `add_decayed_weights(wd)` then `adam(schedule)`, wrapped in
`MultiSteps(k)` when `grad_acc_steps = k > 1`.

- Weight decay is L2 added to the gradient before Adam, on every
  parameter, the KPConv kernel points included: they take no gradient
  (torch holds them with requires_grad=False, flax behind stop_gradient),
  so they get a zero gradient here and move by Adam on `wd * p` alone.
- The schedule (staircase exponential decay per `steps_per_epoch *
  lr_decay_steps` updates, or warmup-cosine) is evaluated at the count of
  inner updates, in float32 as optax does.
- MultiSteps: a running mean of k gradients, one inner update every k
  calls, zero updates in between.

The optimizer state mirrors optax's (NamedTuples, tuples and per-parameter
dicts keyed by the model's parameter names, counts as Python ints), so
that engine/checkpoint.py writes it in the layout of
`flax.serialization.to_state_dict` of the JAX optimizer state.

The train step averages the per-pair losses of a list of pairs and runs
one backward. A non-finite gradient (read by one host sync per step)
zeroes the gradients and the updates, but the optimizer update still runs:
Adam's moments see `wd * p`, and the counts and the schedule advance, as
in the JAX step. In a process group (parallel/mesh.py) each rank steps
its own pairs, and the step takes the gradients' mean across ranks before
the guard and reduces the metrics, as the JAX step's sharded batch does.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from gaussreg_tpu_torch.config import Config
from gaussreg_tpu_torch.data.pipeline import PairBatch
from gaussreg_tpu_torch.device import DeviceLike, resolve_device
from gaussreg_tpu_torch.models.losses import overall_loss
from gaussreg_tpu_torch.models.metrics import evaluate_registration, inlier_ratio
from gaussreg_tpu_torch.models.registration import GaussRegModel
from gaussreg_tpu_torch.parallel.mesh import all_reduce_mean_, all_reduce_sum_, world_size

Params = Dict[str, torch.Tensor]


class EmptyState(NamedTuple):
    pass


class ScaleByAdamState(NamedTuple):
    count: int
    mu: Params
    nu: Params


class ScaleByScheduleState(NamedTuple):
    count: int


class MultiStepsState(NamedTuple):
    mini_step: int
    gradient_step: int
    inner_opt_state: Any
    acc_grads: Params
    skip_state: Tuple = ()


def _f32(x) -> np.float32:
    return np.float32(x)


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float) -> Callable[[int], float]:
    """optax.exponential_decay with staircase=True (transition_begin 0, no
    end value)."""

    def schedule(count: int) -> float:
        if count <= 0:
            return float(_f32(init_value))
        p = np.floor(_f32(count) / _f32(transition_steps))
        return float(_f32(init_value) * np.power(_f32(decay_rate), p))

    return schedule


def warmup_cosine(peak: float, warmup: int, total: int, eta_init: float,
                  eta_min: float) -> Callable[[int], float]:
    """Linear eta_init -> 1 over `warmup` updates, then cosine 1 -> eta_min
    over the rest, times `peak` (the JAX make_optimizer's schedule)."""

    def schedule(count: int) -> float:
        step = _f32(count)
        if count < warmup:
            return float(_f32(peak) * (_f32(eta_init) + _f32(1.0 - eta_init) * step
                                       / _f32(max(warmup, 1))))
        t = np.clip((step - _f32(warmup)) / _f32(max(total - warmup, 1)), _f32(0), _f32(1))
        cos = _f32(1.0) + np.cos(_f32(math.pi) * t)
        return float(_f32(peak) * (_f32(eta_min) + _f32(0.5 * (1.0 - eta_min)) * cos))

    return schedule


# optax.adam's defaults, the only values the JAX package uses
B1, B2, EPS = 0.9, 0.999, 1e-8


class Optimizer:
    """Adam with a learning rate (a float or a schedule of the update
    count), after optional L2 weight decay, and optionally
    MultiSteps(every_k). `init(params)` gives the state; `update(grads,
    state, params)` gives (updates, new state), the updates to add to the
    parameters, as optax's GradientTransformation does."""

    def __init__(self, learning_rate: Union[float, Callable[[int], float]],
                 weight_decay: Optional[float] = None, every_k: int = 1):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.every_k = every_k

    # ------------------------------------------------------------ inner chain

    def _inner_init(self, params: Params):
        zeros = lambda: {n: torch.zeros_like(p) for n, p in params.items()}
        adam = (ScaleByAdamState(0, zeros(), zeros()),
                ScaleByScheduleState(0) if callable(self.learning_rate) else EmptyState())
        return adam if self.weight_decay is None else (EmptyState(), adam)

    def _inner_update(self, grads: Params, state, params: Params):
        names = list(grads)
        g = [grads[n] for n in names]
        if self.weight_decay is not None:
            g = torch._foreach_add(g, [params[n].detach() for n in names], alpha=self.weight_decay)
            decay_state, (adam, sched) = state
        else:
            adam, sched = state
        mu = torch._foreach_mul([adam.mu[n] for n in names], B1)
        torch._foreach_add_(mu, g, alpha=1.0 - B1)
        nu = torch._foreach_mul([adam.nu[n] for n in names], B2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - B2)
        count = adam.count + 1
        bc1 = float(_f32(1) - np.power(_f32(B1), _f32(count)))
        bc2 = float(_f32(1) - np.power(_f32(B2), _f32(count)))
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, denom)
        if callable(self.learning_rate):
            lr = self.learning_rate(sched.count)
            sched = ScaleByScheduleState(sched.count + 1)
        else:
            lr = float(_f32(self.learning_rate))
        torch._foreach_mul_(upd, -lr)
        adam = ScaleByAdamState(count, dict(zip(names, mu)), dict(zip(names, nu)))
        new_state = (adam, sched) if self.weight_decay is None else (decay_state, (adam, sched))
        return dict(zip(names, upd)), new_state

    # --------------------------------------------------------------- public

    def init(self, params: Params):
        inner = self._inner_init(params)
        if self.every_k == 1:
            return inner
        acc = {n: torch.zeros_like(p) for n, p in params.items()}
        return MultiStepsState(0, 0, inner, acc, ())

    @torch.no_grad()
    def update(self, grads: Params, state, params: Params):
        if self.every_k == 1:
            return self._inner_update(grads, state, params)
        names = list(grads)
        acc = [state.acc_grads[n] for n in names]
        # Welford running mean: acc + (g - acc) / (n + 1)
        delta = torch._foreach_sub([grads[n] for n in names], acc)
        torch._foreach_div_(delta, float(state.mini_step + 1))
        acc = torch._foreach_add(acc, delta)
        if state.mini_step == self.every_k - 1:
            updates, inner = self._inner_update(dict(zip(names, acc)), state.inner_opt_state,
                                                params)
            zero = {n: torch.zeros_like(a) for n, a in zip(names, acc)}
            return updates, MultiStepsState(0, state.gradient_step + 1, inner, zero, ())
        updates = {n: torch.zeros_like(a) for n, a in zip(names, acc)}
        return updates, MultiStepsState(state.mini_step + 1, state.gradient_step,
                                        state.inner_opt_state, dict(zip(names, acc)), ())


def adam(learning_rate: Union[float, Callable[[int], float]]) -> Optimizer:
    """optax.adam(learning_rate): no weight decay, no accumulation."""
    return Optimizer(learning_rate)


def make_optimizer(cfg: Config, steps_per_epoch: int, world_size: int = 1) -> Optimizer:
    """Adam + LR schedule + L2 weight decay, lr scaled by the world size;
    schedules: per-epoch staircase exponential decay ("step") or
    warmup-cosine ("cosine")."""
    o = cfg.optim
    peak = o.lr * world_size
    if o.scheduler == "cosine":
        total = max(1, steps_per_epoch * o.max_epoch)
        schedule = warmup_cosine(peak, min(o.warmup_steps, total - 1), total, o.eta_init,
                                 o.eta_min)
    else:
        schedule = exponential_decay(peak, max(1, steps_per_epoch * o.lr_decay_steps),
                                     o.lr_decay)
    return Optimizer(schedule, weight_decay=o.weight_decay, every_k=max(1, o.grad_acc_steps))


class TrainState(NamedTuple):
    params: Params  # the model's parameters, by name; the step updates them in place
    opt_state: Any
    step: int
    skipped: int  # updates skipped for a non-finite gradient


def create_train_state(cfg: Config, model: GaussRegModel, generator: torch.Generator,
                       tx: Optimizer, device: DeviceLike = None) -> TrainState:
    """Move `model` to `device` (default cuda; raises without it), draw its
    parameters as the JAX model's init does from the CPU `generator`, and
    initialise the optimizer state."""
    model.to(resolve_device(device))
    model.reset_parameters(generator)
    params = dict(model.named_parameters())
    return TrainState(params, tx.init(params), 0, 0)


def _coarse_precision(cfg: Config, out) -> torch.Tensor:
    """Share of the proposed node correspondences that overlap in the GT."""
    gt_map = out["gt_node_overlaps"] > cfg.eval.acceptance_overlap
    valid = out["node_corr_valid"]
    hits = gt_map[out["ref_node_corr_indices"], out["src_node_corr_indices"]] & valid
    return hits.sum() / torch.clamp_min(valid.sum(), 1)


def _voxel_overflow(cfg: Config, batch: PairBatch) -> torch.Tensor:
    """Voxels dropped by the static pyramid capacities plus the radius
    searches' truncated run entries: > 0 means the capacities are too
    small for this data."""
    over = batch.pyramid.search_overflow.sum().to(torch.int64)
    for nv, cap in zip(batch.pyramid.num_voxels[1:], cfg.capacity.levels[1:]):
        over = over + torch.clamp_min(nv.to(torch.int64) - cap, 0).sum()
    return over


def _all_finite(tensors: List[torch.Tensor]) -> bool:
    """One host sync: 0 * x is NaN exactly where x is NaN or infinite."""
    norms = torch._foreach_norm(torch._foreach_mul(tensors, 0.0))
    return bool(torch.isfinite(torch.stack(norms)).all())


def apply_gradients(tx: Optimizer, params: Params, opt_state, grads: Params):
    """The JAX step's update with its NaN/Inf guard: a non-finite gradient
    zeroes the gradients and the updates, but `tx.update` still runs (the
    moments see `wd * p`, the counts and the schedule advance). Updates
    `params` in place; returns (opt_state, finite)."""
    finite = _all_finite(list(grads.values()))
    if not finite:
        grads = {n: torch.zeros_like(g) for n, g in grads.items()}
    updates, opt_state = tx.update(grads, opt_state, params)
    if finite:
        with torch.no_grad():
            torch._foreach_add_(list(params.values()), [updates[n] for n in params])
    return opt_state, finite


def pair_generator(device: DeviceLike, *key: int) -> torch.Generator:
    """A generator of `device` seeded from the integers `key` (the train
    CLI's (cfg.seed + 1, step, pair index in the global batch)), so that a
    pair's draws do not depend on the rank that takes it or on the world
    size, as the JAX CLI's per-pair keys (`jax.random.split(sub,
    batch_size)`) do not."""
    seed = int(np.random.SeedSequence(list(key)).generate_state(1, np.uint64)[0] >> 1)
    return torch.Generator(device=device).manual_seed(seed)


def make_train_step(model: GaussRegModel, cfg: Config, tx: Optimizer):
    """train_step(state, batches, generators) -> (state, metrics): the mean
    of the pairs' losses, one backward, the NaN/Inf guard and the optimizer
    update. `generators` holds one generator per pair (of the batches'
    device); each draws its pair's GT node pairs.

    In a process group the gradients' mean across ranks is taken after the
    backward and before the guard, so that every rank takes the same
    decision and applies the same update; the metrics are reduced in one
    flat tensor (global means, the global sum of vox_overflow). Without
    one, nothing is communicated."""

    def train_step(state: TrainState, batches: Sequence[PairBatch],
                   generators: Sequence[torch.Generator]) -> Tuple[TrainState, Dict[str, Any]]:
        if len(generators) != len(batches):
            raise ValueError(f"{len(batches)} pairs but {len(generators)} generators")
        params = state.params
        for p in params.values():
            p.grad = None
        aux = []
        for batch, generator in zip(batches, generators):
            out = model(batch, generator, train=True, with_transform=False)
            losses = dict(overall_loss(cfg, out, batch.transform))
            losses["PIR"] = _coarse_precision(cfg, out)
            losses["vox_overflow"] = _voxel_overflow(cfg, batch)
            aux.append(losses)
        loss = torch.stack([a["loss"] for a in aux]).mean()
        loss.backward()
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad
                 for n, p in params.items()}
        all_reduce_mean_(grads.values())
        opt_state, finite = apply_gradients(tx, params, state.opt_state, grads)
        for p in params.values():
            p.grad = None
        mean = lambda key: torch.stack([a[key].detach().float() for a in aux]).mean()
        local = torch.stack([loss.detach(), mean("c_loss"), mean("f_loss"), mean("PIR"),
                             torch.stack([a["vox_overflow"] for a in aux]).sum().float()])
        world = world_size()
        if world > 1:
            all_reduce_sum_(local)
            local[:4] /= world
        metrics = {
            "loss": local[0],
            "c_loss": local[1],
            "f_loss": local[2],
            "PIR": local[3],
            "grad_finite": float(finite),
            "vox_overflow": local[4],
        }
        return TrainState(params, opt_state, state.step + 1, state.skipped + (not finite)), metrics

    return train_step


def make_eval_step(model: GaussRegModel, cfg: Config):
    """eval_step(batch, generator) -> (estimated_transform, metrics) for one
    pair with the model's current weights: the full forward with LGR and
    RANSAC (hypotheses drawn with `generator`), the registration metrics in
    the normalized frame, the proposals' precision PIR, the inlier ratio IR
    of the dense correspondences, and the capacity overflows."""

    @torch.no_grad()
    def eval_step(batch: PairBatch, generator: torch.Generator):
        out = model(batch, generator, train=False, with_transform=True, with_gt_overlaps=True)
        est = out["estimated_transform"]
        metrics = dict(evaluate_registration(
            cfg, batch.transform, est, batch.pyramid.points[0][1], batch.pyramid.masks[0][1]
        ))
        metrics["PIR"] = _coarse_precision(cfg, out)
        metrics["IR"] = inlier_ratio(out["ref_corr_points"], out["src_corr_points"],
                                     out["corr_valid"], batch.transform,
                                     cfg.eval.acceptance_radius)
        metrics["vox_overflow"] = _voxel_overflow(cfg, batch).float()
        metrics["corr_overflow"] = torch.clamp_min(
            out["num_correspondences"] - cfg.capacity.max_correspondences, 0).float()
        return est, metrics

    return eval_step
