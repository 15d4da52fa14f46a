"""The import guard: top-level names compared whole; a benchmark run's
modules load neither JAX nor the JAX package."""

import subprocess
import sys

from portbench import guard, spec


def test_guard_compares_whole_top_level_names():
    names = ["gaussreg_tpu_torch", "gaussreg_tpu_torch.ops", "jaxtyping", "flaxen", "torch",
             "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "gaussreg_tpu",
             "gaussreg_tpu.ops.select_k"]
    assert guard.forbidden_modules(names) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "gaussreg_tpu",
         "gaussreg_tpu.ops.select_k"])


def test_a_run_loads_no_jax():
    """Every module a run imports (the harness, each runner, the references,
    the program) in a fresh process, then the guard."""
    code = (
        "import importlib, os, sys\n"
        "from portbench import guard, run, spec, control\n"
        "for d in sorted(os.listdir(os.path.join(spec.PKG, 'runners'))):\n"
        "    if d.endswith('.py') and d != '__init__.py':\n"
        "        importlib.import_module('portbench.runners.' + d[:-3])\n"
        "for m in ('coarse', 'weights'):\n"
        "    importlib.import_module('portbench.reference.' + m)\n"
        "import gaussreg_tpu_torch.api\n"
        "bad = guard.forbidden_modules()\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_main_refuses_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/, a run
    exits non-zero and prints no result."""
    import shutil

    shutil.copy(f"{spec.ROOT}/BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload", "indoor_pairs",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "the program is not in this checkout" in out.stderr, out.stderr
