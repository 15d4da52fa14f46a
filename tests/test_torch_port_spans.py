"""The program's own spans (engine/debug.py `annotate`): a shared null
context while no profiler records, and under one a `record_function` range
where each layer's work happens, in the same chrome trace as the device's
events. One tiny coarse call on the CPU, made with the profiler off and
then under `debug.profile_trace`."""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

SEARCHES = [f"pair_batch.search.self.{l}" for l in range(5)] + [
    f"pair_batch.search.{k}.{l}" for k in ("down", "up") for l in range(4)]
# every span of a coarse call, with the span it nests in
PARENTS = {
    "coarse_call": None,
    "pair_batch": "coarse_call",
    "pair_batch.upload": "pair_batch",
    **{f"pair_batch.sort.{l}": "pair_batch" for l in range(5)},
    **{f"pair_batch.subsample.{l}": "pair_batch" for l in range(1, 5)},
    **{s: "pair_batch" for s in SEARCHES},
    **{s: "coarse_call" for s in ("partition", "backbone", "transformer", "matching",
                                  "patch_scores", "sinkhorn", "LGR", "RANSAC")},
    **{f"backbone.{s}": "backbone"
       for s in ("geometry", "encoder1", "encoder2", "encoder3", "encoder4", "encoder5",
                 "decoder")},
    "transformer.embedding": "transformer",
    "transformer.layers": "transformer",
}


@pytest.fixture(scope="module")
def calls(tmp_path_factory):
    """(output with the profiler off, output under debug.profile_trace, the
    trace's complete events) of one tiny coarse call with the same seed."""
    from gaussreg_tpu_torch import api
    from gaussreg_tpu_torch.config import make_tiny_cfg
    from gaussreg_tpu_torch.data.synthetic import random_pair
    from gaussreg_tpu_torch.engine import debug
    from gaussreg_tpu_torch.models.registration import create_model

    cfg = make_tiny_cfg()
    model = create_model(cfg, "cpu")
    model.reset_parameters(torch.Generator().manual_seed(0))
    pair = random_pair(cfg, 0, num_points=600)[:4]
    off = api.coarse_register_clouds(cfg, model, *pair, seed=3, device="cpu")
    log_dir = str(tmp_path_factory.mktemp("spans"))
    with debug.profile_trace(log_dir):
        on = api.coarse_register_clouds(cfg, model, *pair, seed=3, device="cpu")
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    return off, on, events


def test_annotate_is_a_shared_null_context_without_a_profiler(monkeypatch):
    from gaussreg_tpu_torch.engine import debug

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    span = debug.annotate("backbone")
    assert isinstance(span, contextlib.nullcontext)
    assert span is debug.annotate("RANSAC")
    with debug.annotate("backbone"):
        torch.ones(3).sum()


def test_annotate_opens_a_range_under_a_profiler():
    from torch.profiler import ProfilerActivity, profile

    from gaussreg_tpu_torch.engine import debug

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        span = debug.annotate("a_span")
        assert isinstance(span, torch.profiler.record_function)
        with span:
            torch.ones(3).sum()
    assert [e.name for e in prof.events()].count("a_span") == 1


def test_profile_trace_writes_the_spans_as_user_annotations(calls):
    _, _, events = calls
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert set(PARENTS) <= names


def test_a_coarse_call_opens_every_span_once_in_its_parent(calls):
    _, _, events = calls
    spans = [e for e in events if e.get("cat") == "user_annotation" and e["name"] in PARENTS]
    assert sorted(e["name"] for e in spans) == sorted(PARENTS)
    at = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in spans}
    call = at["coarse_call"]
    for name, parent in PARENTS.items():
        lo, hi = at[name]
        assert call[0] <= lo <= hi <= call[1], name
        if parent is not None:
            assert at[parent][0] <= lo <= hi <= at[parent][1], (name, parent)


def test_the_outputs_do_not_depend_on_the_profiler(calls):
    off, on, _ = calls
    assert off.keys() == on.keys()
    for key, a in off.items():
        b = on[key]
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), key
        elif key == "batch":
            for x, y in zip(torch.utils._pytree.tree_leaves(a), torch.utils._pytree.tree_leaves(b)):
                assert torch.equal(x, y)
        else:
            assert np.array_equal(np.asarray(a), np.asarray(b)), key
