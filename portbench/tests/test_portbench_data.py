"""A cell, a configuration and a per-layer metric are added as data: new
files and BENCHMARK.json entries, with no file of the harness edited."""

import json
import shutil

from portbench import spec
from portbench.tests import helpers


def test_a_new_cell_is_found_by_name(tmp_path):
    root = tmp_path
    pkg = root / "portbench"
    shutil.copytree(spec.PKG, pkg, ignore=shutil.ignore_patterns("_build", "__pycache__"))
    before = {p.relative_to(pkg): p.read_bytes() for p in pkg.rglob("*") if p.is_file()}

    bench = json.loads(open(f"{spec.ROOT}/BENCHMARK.json").read())
    traffic = json.loads((pkg / "traffic" / "pairs_easy_30k.json").read_text())
    traffic.update(tier="hard", about="hard-tier pairs")
    (pkg / "traffic" / "pairs_hard_30k.json").write_text(json.dumps(traffic))
    config = json.loads((pkg / "configs" / "gaussreg_indoor.json").read_text())
    config["capacity"]["window_rows0"] = 3
    (pkg / "configs" / "gaussreg_indoor_w3.json").write_text(json.dumps(config))
    (pkg / "metrics" / "pyramid_calls.pairs_hard.py").write_text(
        "def read(trace):\n    return float(trace.calls)\n")
    bench["configs"].append({"name": "gaussreg_indoor_w3", "source": "https://arxiv.org/abs/2407.05254",
                             "file": "portbench/configs/gaussreg_indoor_w3.json", "reduced": [],
                             "why": "three-row level-0 windows"})
    bench["workloads"].append({"name": "indoor_pairs_hard", "config": "gaussreg_indoor_w3",
                               "traffic": "pairs_hard_30k", "chips": 1, "why": "hard tier"})
    bench["per_layer"].append({"name": "pyramid_calls.pairs_hard", "unit": "calls",
                               "better": "lower", "source": "program_counter",
                               "layer": "pyramid", "moves": "pair_ms",
                               "workloads": ["indoor_pairs_hard"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "indoor_pairs" in m["workloads"]:
            m["workloads"].append("indoor_pairs_hard")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("indoor_pairs_hard", root=str(root), pkg=str(pkg))
    assert cell.traffic["tier"] == "hard"
    assert cell.config["capacity"]["window_rows0"] == 3
    assert cell.runner().__name__ == "portbench.runners.coarse_pairs"
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "pair_ms", "pair_p95_ms"}
    assert [m["name"] for m in cell.per_layer] == ["pyramid_calls.pairs_hard"]
    reader = spec.metric_reader("pyramid_calls.pairs_hard", pkg=str(pkg))
    assert reader(type("T", (), {"calls": 3})()) == 3.0
    # the program's config is built from the new file
    from gaussreg_tpu_torch.config import Config

    assert spec.program_config(cell.config, Config).capacity.window_rows0 == 3
    after = {p.relative_to(pkg): p.read_bytes() for p in pkg.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert {k: v for k, v in after.items() if k in before} == before


def test_every_benchmark_entry_has_its_files():
    bench = json.loads(open(f"{spec.ROOT}/BENCHMARK.json").read())
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.runner().Runner
        for m in cell.per_layer:
            assert callable(spec.metric_reader(m["name"]))
    assert helpers.tiny_config()["weights"] is None
