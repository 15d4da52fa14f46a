"""What the harness finds by name: BENCHMARK.json at the checkout's root,
`portbench/configs/<config>.json`, `portbench/traffic/<traffic>.json` (which
names its runner, a module under `portbench/runners/`) and
`portbench/metrics/<metric>.py` (a per-layer metric's reader, whose
`read(trace)` returns a number or None). Adding a cell, a configuration or
a per-layer metric adds files and BENCHMARK.json entries; no file here
changes."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict  # the configuration file's contents
    traffic_name: str
    traffic: dict  # the traffic file's contents
    end_to_end: List[dict]  # the BENCHMARK.json entries this cell reports
    per_layer: List[dict]

    def runner(self):
        return importlib.import_module(f"portbench.runners.{self.traffic['runner']}")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT, pkg: str = PKG) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json with its files under `pkg`."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config_name=w["config"],
        config=load_json(os.path.join(root, conf["file"])),
        traffic_name=w["traffic"],
        traffic=load_json(os.path.join(pkg, "traffic", f"{w['traffic']}.json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def metric_reader(name: str, pkg: str = PKG) -> Callable[[object], Optional[float]]:
    """`read` of portbench/metrics/<name>.py (loaded by path: names hold dots)."""
    path = os.path.join(pkg, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def program_config(doc: Dict, config_cls):
    """An instance of the frozen dataclass `config_cls` (the program's
    `Config`) from a configuration file's fields: nested groups
    become their dataclasses, lists tuples; keys the dataclass lacks (the
    file's notes) are ignored."""
    import dataclasses

    kwargs = {}
    for f in dataclasses.fields(config_cls):
        if f.name not in doc:
            continue
        v = doc[f.name]
        default = f.default if f.default is not dataclasses.MISSING else None
        if dataclasses.is_dataclass(default):
            v = program_config(v, type(default))
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return config_cls(**kwargs)
