"""Train the coarse registration model on ScanNet-GSReg or on synthetic
pairs (port of tools/trainval.py, with the same flags and defaults, plus
--cpu).

reference: experiments/geotransformer.gaussian_splatting.indoor/trainval.py:15-64
and the epoch loop at geotransformer/engine/epoch_based_trainer.py:82-181.

    python -m gaussreg_tpu_torch.tools.trainval --data_root /path/to/ScanNet-GSReg \\
        --output_dir output [--resume] [--synthetic] [--cpu]
    torchrun --nproc_per_node=N -m gaussreg_tpu_torch.tools.trainval ... --distributed

One process drives one device. With --distributed the processes form a
torch.distributed group (parallel/mesh.py: NCCL on cards, gloo with --cpu)
from --coordinator/--num_processes/--process_id or from torchrun's
environment; each rank builds its slice of the global batch, and the
train step averages the gradients across the ranks. Pair i of step s
draws its GT node pairs from a generator seeded with (cfg.seed + 1, s, i),
i its index in the global batch, so the draws do not depend on the world
size. Only rank 0 logs, validates and writes checkpoints. Runs on CUDA
unless --cpu is given: without a card the default raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import queue
import threading
import time
import zipfile
from typing import Callable, Iterator, List

import numpy as np


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--data_root", default=None)
    parser.add_argument("--output_dir", default="output/gaussreg_tpu")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument(
        "--init_from", default=None,
        help="checkpoint to warm-start params from (fresh optimizer); "
        "ignored when --resume finds a snapshot",
    )
    parser.add_argument("--max_epoch", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None,
                        help="global pairs per step (default: one per rank)")
    parser.add_argument("--log_steps", type=int, default=10)
    parser.add_argument("--val_pairs", type=int, default=64)
    parser.add_argument(
        "--val_subset", default="test",
        help="dataset split evaluated each epoch when --data_root is given "
        "(ScanNet-GSReg ships train/test; reference validates on test)",
    )
    parser.add_argument(
        "--synthetic", action="store_true",
        help="train on synthetic pairs (no dataset required; smoke/bench)",
    )
    parser.add_argument("--synthetic_pairs", type=int, default=256)
    parser.add_argument("--distributed", action="store_true",
                        help="join a torch.distributed process group")
    parser.add_argument(
        "--coordinator", default=None,
        help="host:port of rank 0 (pass with --num_processes/--process_id); "
        "without it the group is read from torchrun's environment",
    )
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    parser.add_argument(
        "--tiny", action="store_true",
        help="tiny capacities: CPU smoke run of the full CLI path",
    )
    parser.add_argument("--lr", type=float, default=None, help="override cfg.optim.lr")
    parser.add_argument(
        "--capacity_factor", type=float, default=None,
        help="scale pyramid level capacities (full model dims; CPU/mid runs)",
    )
    parser.add_argument(
        "--scheduler", default=None, choices=["step", "cosine"],
        help="override cfg.optim.scheduler",
    )
    parser.add_argument(
        "--hard_fraction", type=float, default=0.0,
        help="fraction of the synthetic training pool drawn from the hard "
        "tier (overlap 0.3-0.65, full scale aug)",
    )
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    return parser


def configure(args):
    """make_cfg() (or make_tiny_cfg()) with the CLI's overrides, each as
    the JAX CLI applies it."""
    from gaussreg_tpu_torch.config import make_cfg, make_tiny_cfg

    cfg = make_tiny_cfg() if args.tiny else make_cfg()
    if args.capacity_factor is not None:
        cfg = dataclasses.replace(
            cfg,
            capacity=cfg.capacity.scaled(args.capacity_factor),
            train=dataclasses.replace(
                cfg.train,
                point_limit=max(64, int(cfg.train.point_limit * args.capacity_factor)),
            ),
        )
    if args.lr is not None or args.scheduler is not None:
        cfg = dataclasses.replace(
            cfg,
            optim=dataclasses.replace(
                cfg.optim,
                lr=args.lr if args.lr is not None else cfg.optim.lr,
                scheduler=args.scheduler or cfg.optim.scheduler,
                warmup_steps=500 if args.scheduler == "cosine" else cfg.optim.warmup_steps,
            ),
        )
    if args.max_epoch is not None:
        # keep the cosine schedule's length in step with the run's
        cfg = dataclasses.replace(
            cfg, optim=dataclasses.replace(cfg.optim, max_epoch=args.max_epoch)
        )
    return cfg


def batch_leaves(pb) -> list:
    """A PairBatch's tensors in the JAX package's tree order (pyramid
    fields, features, transform)."""
    out = []
    for field in (*pb.pyramid, pb.features, pb.transform):
        out.extend(field if isinstance(field, tuple) else (field,))
    return out


def batch_from_leaves(leaves: list, like):
    """The inverse of `batch_leaves`, shaped like the PairBatch `like`."""
    from gaussreg_tpu_torch.data.pipeline import PairBatch, Pyramid

    it = iter(leaves)
    take = lambda f: tuple(next(it) for _ in f) if isinstance(f, tuple) else next(it)
    pyramid = Pyramid(*(take(f) for f in like.pyramid))
    return PairBatch(pyramid, take(like.features), take(like.transform))


def prefetched(items: Iterator, build: Callable, build_seconds: List[float], device,
               depth: int = 2) -> Iterator:
    """Build batches in a worker thread, `depth` ahead of the consumer (the
    reference gets this from DataLoader workers, utils/torch.py:48-77). The
    worker makes a `device` with an index its current device (a thread's
    own setting, which kernel launches read; a rank's card need not be
    card 0). A failure in the worker is raised in the
    consumer. The worker's seconds per batch are appended to
    `build_seconds`."""
    import torch

    q = queue.Queue(maxsize=depth)
    done = object()
    failure = []

    def worker():
        try:
            if device.type == "cuda" and device.index is not None:
                torch.cuda.set_device(device)
            for item in items:
                t0 = time.perf_counter()
                batch = build(item)
                build_seconds.append(time.perf_counter() - t0)
                q.put(batch)
        except Exception as e:  # handed to the consumer, which raises it
            failure.append(e)
        finally:
            q.put(done)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    while True:
        item = q.get()
        if item is done:
            thread.join()
            if failure:
                raise failure[0]
            return
        yield item


def main(argv=None) -> int:
    args = _parser().parse_args(argv)

    import torch

    from gaussreg_tpu_torch.data.pipeline import augment_pair_pose, make_pair_batch
    from gaussreg_tpu_torch.data.synthetic import DATA_VERSION, random_pair
    from gaussreg_tpu_torch.device import resolve_device
    from gaussreg_tpu_torch.engine.checkpoint import (
        load_checkpoint,
        load_metadata,
        save_checkpoint,
    )
    from gaussreg_tpu_torch.engine.summary import (
        ScalarWriter,
        SummaryBoard,
        Timer,
        format_metrics,
        get_logger,
    )
    from gaussreg_tpu_torch.engine.trainer import (
        TrainState,
        create_train_state,
        make_eval_step,
        make_optimizer,
        make_train_step,
        pair_generator,
    )
    from gaussreg_tpu_torch.models.registration import create_model
    from gaussreg_tpu_torch.parallel import mesh

    device = "cpu" if args.cpu else None
    if args.distributed:
        dev = mesh.init_distributed(args.coordinator, args.num_processes, args.process_id,
                                    device=device)
    else:
        dev = resolve_device(device)
    rank = mesh.process_index()

    cfg = configure(args)
    max_epoch = args.max_epoch or cfg.optim.max_epoch
    os.makedirs(args.output_dir, exist_ok=True)
    logger = get_logger(os.path.join(args.output_dir, "train.log") if rank == 0 else None)

    world = mesh.world_size()
    batch_size = args.batch_size or world
    if batch_size % world:
        raise ValueError(f"--batch_size {batch_size} is not a multiple of {world} ranks")
    local = mesh.process_local_batch_slice(batch_size)
    logger.info(f"devices={world} global_batch={batch_size}")

    model = create_model(cfg, dev)

    # data source: each step's global batch, as seeds (synthetic) or items
    val_dataset = None
    if args.synthetic or args.data_root is None:
        logger.info("training on synthetic pairs")
        # a FIXED scene pool, shuffled per epoch (the reference's epoch
        # semantics: 1379 fixed scenes revisited 40x)
        pool = np.random.default_rng(cfg.seed).integers(0, 2**31, size=args.synthetic_pairs)
        steps_per_epoch = args.synthetic_pairs // batch_size

        def pair_iter(epoch):
            order = np.random.default_rng(cfg.seed + epoch).permutation(args.synthetic_pairs)
            for i in range(steps_per_epoch):
                seeds = pool[order[i * batch_size:(i + 1) * batch_size]][local]
                yield epoch, i, [int(s) for s in seeds]
    else:
        from gaussreg_tpu_torch.data.scannet import ScanNetGSRegDataset

        dataset = ScanNetGSRegDataset(
            args.data_root,
            "train",
            point_limit=cfg.train.point_limit,
            use_augmentation=cfg.train.use_augmentation,
            augmentation_noise=cfg.train.augmentation_noise,
            augmentation_rotation=cfg.train.augmentation_rotation,
            seed=cfg.seed + rank,
        )
        steps_per_epoch = len(dataset) // batch_size
        logger.info(f"ScanNet-GSReg train: {len(dataset)} pairs")

        def pair_iter(epoch):
            order = np.random.default_rng(cfg.seed + epoch).permutation(len(dataset))
            for i in range(steps_per_epoch):
                items = [dataset[int(j)] for j in order[i * batch_size:(i + 1) * batch_size][local]]
                yield epoch, i, [
                    (d["ref_points"], d["ref_feats"], d["src_points"], d["src_feats"],
                     d["transform"])
                    for d in items
                ]

        # the held-out split for per-epoch validation (reference
        # epoch_based_trainer.py:134-166 runs the val loader every epoch)
        try:
            val_dataset = ScanNetGSRegDataset(
                args.data_root,
                args.val_subset,
                point_limit=cfg.train.point_limit,
                use_augmentation=False,
                seed=cfg.seed,
            )
            logger.info(f"ScanNet-GSReg {args.val_subset} (validation): "
                        f"{len(val_dataset)} pairs")
        except FileNotFoundError as e:
            logger.info(f"no {args.val_subset} split found ({e}); "
                        "validating on synthetic pairs")

    tx = make_optimizer(cfg, steps_per_epoch, world_size=world)
    example = make_pair_batch(cfg, *random_pair(cfg, 0), device=dev)
    state = create_train_state(cfg, model, torch.Generator().manual_seed(cfg.seed), tx,
                               device=dev)

    start_epoch = 0
    snapshot = os.path.join(args.output_dir, "snapshot.msgpack")
    if args.resume and os.path.exists(snapshot):
        params, opt_state = load_checkpoint(snapshot, state.opt_state)
        model.load_state_dict(params)
        meta = load_metadata(args.output_dir, "snapshot")
        start_epoch = int(meta.get("epoch", 0))
        state = TrainState(state.params, opt_state, int(meta.get("step", 0)), 0)
        logger.info(f"resumed from {snapshot} at epoch {start_epoch}")
    elif args.init_from:
        # warm start: parameters only (fresh optimizer and schedule)
        model.load_state_dict(load_checkpoint(args.init_from))
        logger.info(f"initialized params from {args.init_from}")
    # every rank starts from rank 0's parameters (the JAX mesh replicates
    # them); the optimizer state is the same file's on every rank
    mesh.broadcast_params_(state.params.values())

    train_step = make_train_step(model, cfg, tx)
    eval_step = make_eval_step(model, cfg)
    writer = ScalarWriter(os.path.join(args.output_dir, "events"))

    # ---- per-seed batch cache (synthetic path) ----
    # The pool is fixed and random_pair(cfg, seed) deterministic, so each
    # seed's pyramid (13 radius searches) is the same every epoch: build it
    # once, keep it on disk, replay it from the prefetch thread.
    cache_tag = "-".join(
        map(str, tuple(cfg.capacity.levels) + tuple(cfg.capacity.neighbor_limits))
    ) + (
        f"-{cfg.train.point_limit}-w{cfg.capacity.window_rows0}"
        f"-h{'_'.join(map(str, cfg.capacity.neighbor_limits))}-v{DATA_VERSION}"
    )
    cache_dir = os.path.join(args.output_dir, "batch_cache", cache_tag)
    like = batch_leaves(example)

    def tier_of(seed):
        # a deterministic per-seed tier split: a low hash bucket is hard
        return "hard" if (int(seed) * 2654435761 % 1000) < args.hard_fraction * 1000 else "easy"

    def cached_pair_batch(seed):
        tier = tier_of(seed)
        path = os.path.join(cache_dir, f"{seed}h.npz" if tier == "hard" else f"{seed}.npz")
        if os.path.exists(path):
            try:
                with np.load(path) as f:
                    arrays = [f[f"arr_{i}"] for i in range(len(f.files))]
                if len(arrays) != len(like) or any(a.shape != tuple(t.shape)
                                                   for a, t in zip(arrays, like)):
                    raise ValueError("leaves do not match this configuration's batch")
                leaves = [torch.from_numpy(a).to(dev, t.dtype) for a, t in zip(arrays, like)]
                return batch_from_leaves(leaves, example)
            except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile) as e:
                logger.info(f"batch cache read failed ({path}): {e}")
        pb = make_pair_batch(cfg, *random_pair(cfg, int(seed), tier=tier), device=dev)
        arrays = [t.cpu().numpy() for t in batch_leaves(pb)]
        os.makedirs(cache_dir, exist_ok=True)
        # two ranks may write one seed: each its own temporary, then an
        # atomic rename
        tmp = path + f".tmp{os.getpid()}-{rank}.npz"
        np.savez(tmp, *[
            a.astype(np.int16)
            if a.dtype.kind == "i" and a.size and 0 <= a.min() and a.max() <= 32767
            else a
            for a in arrays
        ])
        os.replace(tmp, path)
        return pb

    def build_batch(item):
        # a fresh rigid pose for every cached pair (rigid maps keep the
        # pyramid's neighbour lists: data/pipeline.py augment_pair_pose),
        # drawn from (epoch, iteration, global pair index) so that it does
        # not depend on the world size
        epoch, it, raw_pairs = item
        return [
            augment_pair_pose(cached_pair_batch(p), np.random.default_rng(
                [cfg.seed + 17, epoch, it, local.start + j]))
            if isinstance(p, (int, np.integer))
            else make_pair_batch(cfg, *p, device=dev)
            for j, p in enumerate(raw_pairs)
        ]

    def host_floats(metrics):
        # ONE device -> host copy for all metrics
        names = list(metrics)
        vals = torch.stack([torch.as_tensor(metrics[k], device=dev).float().reshape(())
                            for k in names]).tolist()
        return dict(zip(names, vals))

    step_count = int(state.step)
    for epoch in range(start_epoch, max_epoch):
        board = SummaryBoard(last_n=args.log_steps)
        timer = Timer()
        build_seconds: List[float] = []
        timer.tic("prepare")
        for it, batches in enumerate(prefetched(pair_iter(epoch), build_batch, build_seconds,
                                                dev)):
            gens = [pair_generator(dev, cfg.seed + 1, step_count, local.start + j)
                    for j in range(len(batches))]
            timer.toc("prepare")
            timer.tic("process")
            state, metrics = train_step(state, batches, gens)
            metrics = host_floats(metrics)
            timer.toc("process")
            board.update_from_dict(metrics)
            step_count += 1
            if (it + 1) % args.log_steps == 0:
                logger.info(
                    f"epoch {epoch} it {it + 1}/{steps_per_epoch}: "
                    f"{format_metrics(board.smoothed_summary())}, "
                    f"prep {timer.mean('prepare'):.3f}s proc {timer.mean('process'):.3f}s"
                )
                writer.write("train", board.smoothed_summary(), step_count)
            timer.tic("prepare")
        logger.info(
            f"epoch {epoch} trained: prep {timer.mean('prepare'):.4f}s proc "
            f"{timer.mean('process'):.4f}s per step; the prefetch thread built a batch in "
            f"{float(np.mean(build_seconds)) if build_seconds else 0.0:.4f}s"
        )

        # validation on rank 0 (the only rank that logs): the dataset's
        # held-out split when there is one, else a synthetic holdout
        if rank == 0:
            val_board = SummaryBoard()
            if val_dataset is not None:
                for i in range(min(args.val_pairs, len(val_dataset))):
                    d = val_dataset[i]
                    vb = make_pair_batch(cfg, d["ref_points"], d["ref_feats"], d["src_points"],
                                         d["src_feats"], d["transform"], device=dev)
                    _, vm = eval_step(vb, torch.Generator(device=dev).manual_seed(i))
                    val_board.update_from_dict(host_floats(vm))
            else:
                for i in range(min(args.val_pairs, 16)):
                    vb = cached_pair_batch(10_000_000 + i)
                    _, vm = eval_step(vb, torch.Generator(device=dev).manual_seed(i))
                    val_board.update_from_dict(host_floats(vm))
            logger.info(f"epoch {epoch} val: {format_metrics(val_board.summary())}")
            writer.write("val", val_board.summary(), step_count)

        meta = {"epoch": epoch + 1, "step": step_count}
        save_checkpoint(args.output_dir, f"epoch-{epoch}", state.params, metadata=meta)
        save_checkpoint(args.output_dir, "snapshot", state.params, state.opt_state,
                        metadata=meta)
        logger.info(f"epoch {epoch} checkpointed")

    writer.close()
    if args.distributed:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
