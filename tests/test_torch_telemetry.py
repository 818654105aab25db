"""The round telemetry (``repro_torch.telemetry``) on the CPU: one
record per ``run_round`` with the span tree of both servers' rounds,
counters equal to what each round's plan implies, spans on the
profiler's clock, nothing recorded (and no metric changed) with
recording off, one ``wall_s`` in memory and in a checkpoint, the ring's
bound, the JSON-lines writer and the kernels' build record. Tiny populations (the MLP, 8 devices), a few rounds each.
"""
import dataclasses
import json
from collections import deque

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import telemetry  # noqa: E402
from repro_torch.configs.fedcd_cifar import HIERARCHICAL  # noqa: E402
from repro_torch.core.fedavg import FedAvgServer  # noqa: E402
from repro_torch.core.fedcd import FedCDServer  # noqa: E402
from repro_torch.core.plan import EvalHints  # noqa: E402
from repro_torch.core.spec import EngineSpec  # noqa: E402
from repro_torch.data.partition import (hierarchical_devices,  # noqa: E402
                                        stack_devices)
from repro_torch.federated import simulation as sim  # noqa: E402
from repro_torch.federated.simulation import (bucket_size,  # noqa: E402
                                              pad_live_rows)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import mlp  # noqa: E402

SERVERS = {"fedcd": FedCDServer, "fedavg": FedAvgServer}
CASES = [(k, s) for k in SERVERS for s in ("fused", "fused+pipeline")]
# the phases under ``round``, in order, by server and spec
PHASES = {
    ("fedcd", "fused"): ["plan", "launch", "readback", "lifecycle",
                         "collect"],
    ("fedcd", "fused+pipeline"): ["plan", "launch", "speculate", "readback",
                                  "lifecycle", "collect"],
    ("fedavg", "fused"): ["plan", "launch", "readback"],
    ("fedavg", "fused+pipeline"): ["plan", "launch", "speculate",
                                   "readback"],
}


@pytest.fixture(autouse=True)
def fresh():
    telemetry.configure(enabled=True)
    telemetry.reset()
    yield
    telemetry.configure(enabled=True)
    telemetry.reset()


def _server(kind, spec, quantize_bits=0):
    devs = hierarchical_devices(seed=0, devices_per_archetype=1, n_train=64,
                                n_val=32, n_test=32)[:8]
    cfg = dataclasses.replace(
        HIERARCHICAL, n_devices=8, devices_per_round=4, milestones=(2, 5),
        max_models=8, late_delete_round=6, seed=0,
        quantize_bits=quantize_bits)
    params = mlp.init_mlp_classifier(torch.Generator().manual_seed(0),
                                     hidden=32)
    return SERVERS[kind](cfg, params, mlp.mlp_loss, mlp.mlp_accuracy,
                         stack_devices(devs), batch_size=16, spec=spec,
                         device="cpu")


def _children(rec, i):
    return [s[0] for s in rec.spans if s[1] == i]


@pytest.mark.parametrize("kind,spec", CASES)
def test_one_record_per_round_with_the_span_tree(kind, spec):
    srv = _server(kind, spec)
    ms = srv.run(4)
    recs = telemetry.records()
    assert [r.t for r in recs] == [1, 2, 3, 4]
    assert len({r.seq for r in recs}) == 4
    assert {(r.kind, r.server) for r in recs} == {(kind,
                                                   srv._telemetry_id)}
    for rec, m in zip(recs, ms):
        assert rec.spans[0][:2] == ["round", None]
        # the wall runs from the round's start to its metrics
        t0, t1 = rec.spans[0][2:]
        last = max(s[3] for s in rec.spans if s[1] == 0)
        assert (last - t0) * 1e-9 <= m.wall_s <= (t1 - t0) * 1e-9
        assert _children(rec, 0) == PHASES[(kind, spec)]
        launch = [s[0] for s in rec.spans].index("launch")
        assert _children(rec, launch) == ["launch/train", "launch/finish"]
        readback = [s[0] for s in rec.spans].index("readback")
        assert _children(rec, readback) == ["wait", "wait"]
        for name, parent, t0, t1 in rec.spans[1:]:
            p = rec.spans[parent]
            assert p[2] <= t0 <= t1 <= p[3], name
        assert min(rec.self_ns()) >= 0
        assert rec.counters["comm_bytes"] == m.comm_bytes
    if spec.endswith("pipeline"):
        spec_counts = {}
        for rec in recs:
            for k, v in rec.counters.items():
                if k.startswith("spec."):
                    spec_counts[k[5:]] = spec_counts.get(k[5:], 0) + v
        stats = {k: v for k, v in srv.pipeline_stats.as_dict().items() if v}
        assert spec_counts == stats


def _spy(srv, kind):
    """Each round's plan, and the executor's extra eval calls."""
    plans, extra = [], []
    if kind == "fedcd":
        build_plan = srv.planner.build

        def plan(*a, **k):
            plans.append(build_plan(*a, **k))
            return plans[-1]
        srv.planner.build = plan
        eval_rows = srv.executor.eval_rows

        def rows(models, split):
            extra.append((list(models), split))
            return eval_rows(models, split)
        srv.executor.eval_rows = rows
    else:
        fedavg_plan = srv._plan

        def plan(*a, **k):
            out = fedavg_plan(*a, **k)
            if a[0] == len(srv.metrics) + 1:     # not the speculation's
                plans.append(out)
            return out
        srv._plan = plan
    return plans, extra


@pytest.mark.parametrize("quantize_bits", [0, 8])
@pytest.mark.parametrize("kind", sorted(SERVERS))
def test_counters_follow_the_plan(kind, quantize_bits):
    srv = _server(kind, "fused", quantize_bits)
    plans, extra = _spy(srv, kind)
    for t in range(1, 7):
        extra.clear()
        if kind == "fedcd" and t == 4:
            # no predicted test rows: the collect's extra eval reads the
            # preferred models the round changed (test-row misses)
            hints = srv.executor.plan_hints
            srv.executor.plan_hints = lambda: EvalHints(
                hints().val_cached, hints().test_cached, [])
        srv.run_round(t)
        if kind == "fedcd" and t == 4:
            del srv.executor.plan_hints
        plan, c = plans[-1], telemetry.records()[-1].counters
        pairs = len(plan.pair_model)
        assert c["pairs"] == pairs
        assert c["pairs_padded"] == bucket_size(pairs) - pairs
        if kind == "fedavg":
            assert (c["eval_rows"], c["eval_rows_read"]) == (2, 2)
            continue
        val = plan.val_stale or plan.live[:1]
        test = plan.test_stale or plan.live[:1]
        rows = len(pad_live_rows(val)) + len(pad_live_rows(test))
        read = len(plan.val_stale) + len(plan.test_stale)
        refresh = [m for m, split in extra if split == "val"]
        misses = [m for m, split in extra if split == "test"][len(refresh):]
        for models, _ in extra:
            rows += len(pad_live_rows(models))
            read += len(models)
        assert c["eval_rows"] == rows
        assert c["eval_rows_read"] == read
        assert c.get("refresh_rows", 0) == sum(map(len, refresh))
        assert c.get("test_row_misses", 0) == sum(map(len, misses))
        if t == 4:
            assert c["test_row_misses"] > 0
        if quantize_bits and t == 2:                # the milestone clone
            assert c["refresh_rows"] == len(srv.registry.live_ids())


def test_new_shapes_count_first_launches():
    srv = _server("fedavg", "fused")
    srv.run(3)
    counts = [r.counters.get("new_shapes", 0) for r in telemetry.records()]
    # round 1: the 8-pair train bucket; eval row counts are not shapes
    assert counts == [1, 0, 0]


def test_spans_are_on_the_profilers_clock(monkeypatch):
    """Every aten op the pair trainer records under the profiler starts
    inside the round's ``launch/train`` span."""
    pair_train = sim._pair_train

    def marked(loss_fn, lr):
        train = pair_train(loss_fn, lr)

        def run(*a, **k):
            with torch.profiler.record_function("pair_train"):
                return train(*a, **k)
        return run
    monkeypatch.setattr(sim, "_pair_train", marked)
    srv = _server("fedcd", "fused")
    srv.run_round(1)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        srv.run_round(2)
        srv.run_round(3)
    events = [(e.start_ns(), e.end_ns(), e.name())
              for e in prof.profiler.kineto_results.events()]
    marks = sorted((s, e) for s, e, n in events if n == "pair_train")
    spans = sorted((s[2], s[3]) for r in telemetry.records()[-2:]
                   for s in r.spans if s[0] == "launch/train")
    assert len(marks) == len(spans) == 2
    ops = [(s, n) for s, e, n in events if n.startswith("aten::")
           and any(m0 <= s <= m1 for m0, m1 in marks)]
    assert len(ops) > 100
    for s, n in ops:
        assert any(t0 <= s <= t1 for t0, t1 in spans), n


def test_off_records_nothing_and_keeps_every_metric():
    def run(on):
        telemetry.configure(enabled=on)
        srv = _server("fedcd", "fused+pipeline", quantize_bits=8)
        return srv.run(5)
    on = run(True)
    assert len(telemetry.records()) == 5
    telemetry.reset()
    off = run(False)
    assert telemetry.records() == []
    assert not telemetry.process().spans
    for a, b in zip(on, off):
        assert b.wall_s > 0
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        for k in da:
            if k != "wall_s":
                np.testing.assert_array_equal(da[k], db[k], err_msg=k)


@pytest.mark.parametrize("kind", SERVERS)
def test_a_checkpoint_keeps_the_wall_in_memory(kind, tmp_path):
    """``wall_s`` is set once, before the save: a resumed server's
    metrics equal the saving server's."""
    spec = EngineSpec(save_every=2, checkpoint_dir=str(tmp_path))
    ms = _server(kind, spec).run(4)
    resumed = _server(kind, EngineSpec(resume_from=str(tmp_path)))
    assert [m.wall_s for m in resumed.metrics] == [m.wall_s for m in ms]


def test_ring_keeps_the_newest_records(monkeypatch):
    monkeypatch.setattr(telemetry._rec, "records", deque(maxlen=3))
    _server("fedavg", "fused").run(5)
    assert [r.t for r in telemetry.records()] == [3, 4, 5]


def test_jsonl_writer(tmp_path):
    _server("fedavg", "fused").run(2)
    path = tmp_path / "rounds.jsonl"
    assert telemetry.write_jsonl(str(path)) == 3
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert lines[0]["kind"] == "process"
    assert [x["t"] for x in lines[1:]] == [1, 2]
    assert lines[1]["spans"][0][:2] == ["round", None]
    assert lines[2]["counters"] == telemetry.records()[1].counters


def test_kernel_build_is_a_process_span(monkeypatch, tmp_path):
    lib = tmp_path / "libweighted_agg.so"
    lib.write_bytes(b"")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "library_path", lambda name: lib)
    build.build(("weighted_agg",))
    proc = telemetry.process()
    assert [s[0] for s in proc.spans] == ["kernels.build"]
    assert proc.counters == {"library_hits": 1,
                             "library_hits.weighted_agg": 1}
