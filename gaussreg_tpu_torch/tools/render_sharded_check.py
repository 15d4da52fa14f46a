"""render_sharded over N ranks, forward and backward, one record per rank.

    python -m gaussreg_tpu_torch.tools.render_sharded_check --scene scene.npz \\
        --world 2 --output_dir out [--cpu] [--backend gloo] [--tile 32] \\
        [--max_tiles_per_gaussian 16]

`--scene` is an .npz of one model and one view: means (G, 3), scales
(G, 3), quats (G, 4), opacities (G,), sh (G, 3, K) and the camera's w2c
(4, 4), fx, fy, cx, cy, width, height (`write_scene`). The tool launches
`--world` processes, rank r in its own, which meet through a file:// init
in --output_dir (gloo on the CPU, NCCL on cards, `--backend gloo` for
several ranks on one card). Each rank renders its rows of the view with
gs.rasterizer.render.render_sharded and takes the gradient of its share of
the loss sum(rgb * w) + 0.3 sum(T), w = linspace(0.5, 1.5) over the whole
(H, W, 3) image (`loss_weights`), so that the ranks' gradients, summed by
the backward's all-reduce, are those of the whole image's loss.

It renders twice and records the second run: rank<r>.npz holds the
gathered rgb, depth and transmittance of the whole image, this rank's rows,
the gradients of the five gaussian parameters and of w2c ("grad:<name>"),
the counters, the kernel launches of the second run ("launches:<name>"),
its forward and backward milliseconds (host clock between device syncs)
and the milliseconds of one all-reduce of the gradients' size on the
group (median of three, the same collective the backward runs).
The ranks have RANK_TIMEOUT seconds; the launcher stops them all when one
fails or time is up.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from gaussreg_tpu_torch.tools.ddp_check import launch_ranks

RANK_TIMEOUT = 300  # seconds for all ranks together
PARAMS = ("means", "scales", "quats", "opacities", "sh")


def write_scene(path, means, scales, quats, opacities, sh, camera) -> None:
    """Write one model (numpy arrays) and one rasterizer Camera as --scene."""
    np.savez(path, means=means, scales=scales, quats=quats, opacities=opacities, sh=sh,
             w2c=np.asarray(camera.w2c, np.float32), fx=camera.fx, fy=camera.fy,
             cx=camera.cx, cy=camera.cy, width=camera.width, height=camera.height)


def read_scene(path, device):
    """(the five parameter tensors on `device`, the Camera) of a --scene."""
    import torch

    from gaussreg_tpu_torch.gs.rasterizer.camera import Camera

    z = np.load(path)
    params = [torch.as_tensor(np.asarray(z[k], np.float32), device=device) for k in PARAMS]
    camera = Camera(torch.as_tensor(np.asarray(z["w2c"], np.float32), device=device),
                    float(z["fx"]), float(z["fy"]), float(z["cx"]), float(z["cy"]),
                    int(z["width"]), int(z["height"]))
    return params, camera


def loss_weights(height: int, width: int, device):
    """The loss's rgb weights over the whole (H, W, 3) image."""
    import torch

    return torch.linspace(0.5, 1.5, height * width * 3, device=device).reshape(height, width, 3)


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--scene", required=True)
    parser.add_argument("--world", type=int, default=2)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--tile", type=int, default=32, help="tile height and width")
    parser.add_argument("--sh_degree", type=int, default=3)
    parser.add_argument("--max_tiles_per_gaussian", type=int, default=16,
                        help="render_sharded's cap, applied per slice")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    parser.add_argument("--backend", default=None, help="gloo or nccl (default: by device)")
    parser.add_argument("--threads", type=int, default=None, help="torch.set_num_threads")
    parser.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    return parser


def run_rank(args) -> None:
    """Render this rank's rows twice, forward and backward; write the
    second run's record."""
    import torch
    import torch.distributed as dist

    from gaussreg_tpu_torch.gs.rasterizer.render import gather_rows, render_sharded, sharded_rows
    from gaussreg_tpu_torch.ops import _cuda
    from gaussreg_tpu_torch.parallel import mesh

    if args.threads:
        torch.set_num_threads(args.threads)
    init = "file://" + os.path.abspath(os.path.join(args.output_dir, "pg_init"))
    dev = mesh.init_distributed(num_processes=args.world, process_id=args.rank,
                                device="cpu" if args.cpu else None, backend=args.backend,
                                init_method=init)
    base, camera = read_scene(args.scene, dev)
    w2c0 = camera.w2c
    tile = args.tile

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(2):  # the first run loads the kernels; the second is recorded
        params = [p.clone().requires_grad_(True) for p in base]
        w2c = w2c0.clone().requires_grad_(True)
        _cuda.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        out = render_sharded(*params, camera._replace(w2c=w2c), tile_h=tile, tile_w=tile,
                             sh_degree=args.sh_degree,
                             max_tiles_per_gaussian=args.max_tiles_per_gaussian)
        sync()
        t1 = time.perf_counter()
        first, end = sharded_rows(camera.height, tile)
        w = loss_weights(camera.height, camera.width, dev)[first:end]
        loss = torch.sum(out.rgb * w) + 0.3 * torch.sum(out.transmittance)
        loss.backward()
        sync()
        t2 = time.perf_counter()
        counts = _cuda.launch_counts()

    grads = [p.grad for p in params] + [w2c.grad]
    flat = torch.cat([g.reshape(-1) for g in grads])
    reduce_ms = []
    for _ in range(3):
        sync()
        t_r = time.perf_counter()
        dist.all_reduce(flat.clone())
        sync()
        reduce_ms.append((time.perf_counter() - t_r) * 1e3)
    record = {
        "rgb": gather_rows(out.rgb, camera.height, tile).cpu().numpy(),
        "depth": gather_rows(out.depth, camera.height, tile).cpu().numpy(),
        "transmittance": gather_rows(out.transmittance, camera.height, tile).cpu().numpy(),
        "rows": np.array([first, end]),
        "loss": float(loss),
        "fwd_ms": (t1 - t0) * 1e3,
        "bwd_ms": (t2 - t1) * 1e3,
        "allreduce_ms": float(np.median(reduce_ms)),
        "gradient_floats": flat.numel(),
        "world": dist.get_world_size(),
    }
    for name in ("num_pairs", "overflow", "overflow_cap", "sat_blocks", "num_live"):
        record[name] = int(getattr(out, name))
    record.update({f"grad:{n}": g.cpu().numpy() for n, g in zip(PARAMS + ("w2c",), grads)})
    record.update({f"launches:{n}": c for n, c in counts.items()})
    np.savez(os.path.join(args.output_dir, f"rank{args.rank}.npz"), **record)
    dist.destroy_process_group()


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    if args.rank is None:
        if args.world < 2:
            raise SystemExit("render_sharded_check: --world must be at least 2")
        return launch_ranks("gaussreg_tpu_torch.tools.render_sharded_check", args.world,
                            args.output_dir, argv, RANK_TIMEOUT)
    run_rank(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
