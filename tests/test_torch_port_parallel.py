"""Data parallelism of the port (gaussreg_tpu_torch/parallel/mesh.py, the
train step across ranks) and its training CLI (tools/trainval.py) on the
CPU, against the JAX package where it has a counterpart.

The multi-rank runs go through tools/ddp_check.py and tools/trainval.py in
their own processes (gloo on the CPU, torch at 2 threads in every process),
each with a time limit (ddp_check's RANK_TIMEOUT, this file's TIMEOUT), so
that a hang fails one test.

Tolerances of the 2-rank step against the 1-process step on the same two
pairs, with the same weights and per-pair draws:
- step-1 metrics (the losses): equal. Each rank's forward is the 1-process
  forward of its pair, bit for bit; the mean of two numbers is one
  addition either way.
- step-1 gradients handed to the optimizer: within 1e-6 of each leaf's max.
  (g0 + g1) / 2 against autograd's accumulation of both pairs' uses of a
  parameter differs in the order of the last f32 additions (measured
  9.1e-8).
- step-1 parameters: within 1e-6 of each leaf's max, plus, for a leaf that
  starts at zero, lr / eps times the largest gradient difference. Such a
  leaf holds Adam's first update lr * g / (|g| + eps) alone, whose slope
  in g is up to lr / eps, so gradients that agree to 9e-8 of their max
  move it by up to 6.0e-5 of its max (measured: 7 zero-initialised
  transformer kernels); every leaf that starts non-zero agrees within
  1e-6.
- after step 2: the ranks equal each other bit for bit; no comparison
  with the 1-process run, whose gradients are chaotic in the forward's
  last bits from step 2 on.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300
THREADS = ["--threads", "2"]


def _env():
    return {**os.environ, "PYTHONPATH": REPO, "GLOO_SOCKET_IFNAME": "lo", "OMP_NUM_THREADS": "2"}


# ------------------------------------------------------------------ mesh


@pytest.mark.parametrize("world,rank", [(1, 0), (2, 0), (2, 1), (4, 0), (4, 1), (4, 2), (4, 3)])
def test_process_local_batch_slice_equals_jax(monkeypatch, world, rank):
    import jax

    from gaussreg_tpu.parallel import mesh as jax_mesh
    from gaussreg_tpu_torch.parallel import mesh

    monkeypatch.setattr(jax, "process_count", lambda: world)
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    monkeypatch.setattr(mesh, "world_size", lambda: world)
    monkeypatch.setattr(mesh, "process_index", lambda: rank)
    for global_batch in (world, 2 * world, 8):
        assert mesh.process_local_batch_slice(global_batch) == \
            jax_mesh.process_local_batch_slice(global_batch)


def test_single_process_mesh_is_the_identity():
    from gaussreg_tpu_torch.parallel import mesh

    assert mesh.world_size() == 1 and mesh.process_index() == 0
    a, b = torch.arange(3.0), torch.ones(2, 2)
    mesh.all_reduce_mean_([a, b])
    mesh.broadcast_params_([a, b])
    assert torch.equal(a, torch.arange(3.0)) and torch.equal(b, torch.ones(2, 2))
    assert mesh.process_local_batch_slice(4) == slice(0, 4)
    assert mesh.rank_device("cpu") == torch.device("cpu")


# ----------------------------------------------------------- ddp_check runs


def _ddp_check(out, *argv):
    from gaussreg_tpu_torch.tools import ddp_check

    assert ddp_check.main(["--output_dir", str(out), "--pairs", "0", "1", "--cpu", *THREADS,
                           *argv]) == 0


@pytest.fixture(scope="module")
def ddp_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("ddp")
    _ddp_check(base / "w1", "--world", "1", "--steps", "2")
    _ddp_check(base / "w2", "--world", "2", "--steps", "2")
    load = lambda d, r: dict(np.load(os.path.join(base, d, f"rank{r}.npz")))
    return {"w1": load("w1", 0), "r0": load("w2", 0), "r1": load("w2", 1)}


def _keys(record, prefix):
    return sorted(k for k in record if k.startswith(prefix))


def test_two_ranks_step1_losses_equal_one_process(ddp_runs):
    one, r0, r1 = ddp_runs["w1"], ddp_runs["r0"], ddp_runs["r1"]
    assert int(r0["world"]) == int(r1["world"]) == 2 and int(one["world"]) == 1
    keys = _keys(one, "step1:metric:")
    assert {k.split(":")[-1] for k in keys} == {"loss", "c_loss", "f_loss", "PIR", "grad_finite",
                                                "vox_overflow"}
    for k in keys:
        assert float(r0[k]) == float(r1[k]) == float(one[k]), k
    assert float(one["step1:metric:grad_finite"]) == 1.0


def test_two_ranks_step1_gradients_and_parameters_match_one_process(ddp_runs):
    from gaussreg_tpu_torch.config import make_tiny_cfg
    from gaussreg_tpu_torch.engine.trainer import EPS

    one, r0 = ddp_runs["w1"], ddp_runs["r0"]
    lr = make_tiny_cfg().optim.lr * 2  # the schedule's first value, scaled by the two pairs
    for k in _keys(one, "step1:grad:"):
        a, b = one[k], r0[k]
        assert np.abs(a - b).max() <= 1e-6 * np.abs(a).max(), k
    moved = 0
    for k in _keys(one, "step1:param:"):
        name = k.split(":")[-1]
        a, b, start = one[k], r0[k], one[f"step0:param:{name}"]
        np.testing.assert_array_equal(start, r0[f"step0:param:{name}"])
        limit = 1e-6 * np.abs(a).max()
        if not start.any():
            dg = np.abs(one[f"step1:grad:{name}"] - r0[f"step1:grad:{name}"]).max()
            limit += lr / EPS * dg
        assert np.abs(a - b).max() <= limit, k
        moved += not np.array_equal(a, start)
    assert moved > 0


def test_two_ranks_stay_bit_equal(ddp_runs):
    r0, r1 = ddp_runs["r0"], ddp_runs["r1"]
    assert _keys(r0, "") == _keys(r1, "")
    for kind in ("metric", "grad", "param"):  # not the timings
        for k in _keys(r0, f"step2:{kind}:"):
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    assert int(r0["step"]) == int(r1["step"]) == 2 and int(r0["skipped"]) == 0
    # the second step moved the parameters
    assert any(not np.array_equal(r0[k], r0[k.replace("step2", "step1")])
               for k in _keys(r0, "step2:param:"))


def test_nan_on_one_rank_skips_the_update_on_both(tmp_path):
    _ddp_check(tmp_path, "--world", "2", "--steps", "1", "--nan_pair", "1")
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in (0, 1)]
    for rec in ranks:
        assert float(rec["step1:metric:grad_finite"]) == 0.0
        assert int(rec["step"]) == 1 and int(rec["skipped"]) == 1
        for k in _keys(rec, "step1:param:"):
            np.testing.assert_array_equal(rec[k], rec[k.replace("step1", "step0")], err_msg=k)


# ---------------------------------------------------------------- trainval


def _trainval(*argv):
    proc = subprocess.run(
        [sys.executable, "-m", "gaussreg_tpu_torch.tools.trainval", "--cpu", "--tiny", *argv],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=TIMEOUT,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def _meta(out, name):
    import json

    with open(os.path.join(out, f"{name}.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def trainval_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("trainval"))
    common = ["--synthetic", "--synthetic_pairs", "2", "--val_pairs", "1", "--log_steps", "1",
              "--output_dir", out]
    first = _trainval(*common, "--max_epoch", "1")
    second = _trainval(*common, "--max_epoch", "2", "--resume")
    return out, first, second


def test_trainval_writes_epoch_and_snapshot(trainval_run):
    from gaussreg_tpu_torch.engine.checkpoint import load_checkpoint

    out, first, _ = trainval_run
    assert "devices=1 global_batch=1" in first and "epoch 0 it 2/2" in first
    assert "grad_finite: 1" in first and "epoch 0 checkpointed" in first
    assert _meta(out, "epoch-0") == {"epoch": 1, "step": 2}
    sd = load_checkpoint(os.path.join(out, "epoch-0.msgpack"))
    assert sd and all(bool(torch.isfinite(v).all()) for v in sd.values())
    cache = os.path.join(out, "batch_cache")
    (tag,) = os.listdir(cache)
    # the two pool seeds and the validation pair, each cached once
    assert len(os.listdir(os.path.join(cache, tag))) == 3


def test_trainval_resume_continues_at_saved_epoch_and_step(trainval_run):
    out, _, second = trainval_run
    assert "resumed from" in second and "at epoch 1" in second
    assert "epoch 0 it" not in second and "epoch 1 it 2/2" in second
    assert _meta(out, "snapshot") == {"epoch": 2, "step": 4}
    assert _meta(out, "epoch-1") == {"epoch": 2, "step": 4}


def test_trainval_init_from_a_jax_checkpoint(tmp_path):
    """A checkpoint written by the JAX package's save_checkpoint warm-starts
    the twin: with no train step (an empty pool) the epoch's checkpoint
    holds its parameters unchanged."""
    from gaussreg_tpu.engine.checkpoint import save_checkpoint as jax_save
    from gaussreg_tpu_torch.config import make_tiny_cfg
    from gaussreg_tpu_torch.engine.checkpoint import flax_from_params, load_checkpoint
    from gaussreg_tpu_torch.models.registration import create_model

    model = create_model(make_tiny_cfg(), "cpu")
    model.reset_parameters(torch.Generator().manual_seed(5))
    path = jax_save(str(tmp_path), "jax", {"params": flax_from_params(model.state_dict())})
    out = str(tmp_path / "run")
    text = _trainval("--synthetic", "--synthetic_pairs", "0", "--max_epoch", "1",
                     "--val_pairs", "1", "--init_from", path, "--output_dir", out)
    assert f"initialized params from {path}" in text
    saved = load_checkpoint(os.path.join(out, "epoch-0.msgpack"))
    for k, v in model.state_dict().items():
        assert torch.equal(saved[k], v), k


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_trainval_two_processes(tmp_path):
    """--distributed with an explicit coordinator: two gloo ranks run one
    epoch, both exit 0, the log reads devices=2, and only rank 0 logs and
    writes."""
    port, out = _free_port(), str(tmp_path / "run")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "gaussreg_tpu_torch.tools.trainval", "--cpu", "--tiny",
             "--distributed", "--coordinator", f"localhost:{port}", "--num_processes", "2",
             "--process_id", str(pid), "--synthetic", "--synthetic_pairs", "4",
             "--max_epoch", "1", "--val_pairs", "1", "--log_steps", "1", "--output_dir", out],
            cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for pid in range(2)
    ]
    try:
        outputs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, text) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"rank {pid}:\n{text[-4000:]}"
    with open(os.path.join(out, "train.log")) as f:
        log = f.read()
    assert log.count("devices=2 global_batch=2") == 1
    assert log.count("epoch 0 checkpointed") == 1 and "epoch 0 it 2/2" in log
    assert "checkpointed" in outputs[0] and "] [INFO] " not in outputs[1]
    assert _meta(out, "snapshot") == {"epoch": 1, "step": 2}


def test_trainval_failed_process_group_raises(monkeypatch, tmp_path):
    import torch.distributed as dist

    from gaussreg_tpu_torch.tools import trainval

    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError):
        trainval.main(["--cpu", "--tiny", "--distributed", "--synthetic",
                       "--output_dir", str(tmp_path)])
    assert not dist.is_initialized()


# ------------------------------------------------------------- entry points


@pytest.mark.parametrize("tool,argv", [
    ("trainval", ["--tiny", "--synthetic"]),
    ("trainval", ["--tiny", "--synthetic", "--distributed"]),
    ("eval_synthetic", ["--weights", "none.msgpack", "--tiny"]),
    ("eval_scannet", ["--scannet_path", "none", "--tiny"]),
    ("ddp_check", ["--world", "1"]),
])
def test_cli_defaults_to_cuda_and_raises_without_it(monkeypatch, tmp_path, tool, argv):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"gaussreg_tpu_torch.tools.{tool}")
    out = ["--output_dir" if tool != "eval_scannet" else "--output_path", str(tmp_path)]
    if tool == "eval_synthetic":
        out = ["--output", str(tmp_path / "t.json")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(argv + out)
