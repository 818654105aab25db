"""The per-layer metrics that read the program's own round records
(``repro_torch.telemetry``), on tiny traced runs on the CPU: each takes
exactly the window's rounds, ``pad_share.*`` reads the bucket arithmetic
of the window's plans, and each reads nothing where the program has no
telemetry."""
import sys

import pytest
import torch

import repro_torch
from bench_helpers import tiny_job
from fbench import cell as cells
from fbench import program
from fbench.runners import fl_cnn
from repro_torch import telemetry
from repro_torch.core.fedavg import FedAvgServer
from repro_torch.core.plan import RoundPlanner
from repro_torch.federated.simulation import bucket_size

NEW = {"cnn-fedcd-r16": ["host_train_enqueue_ms.cnn", "host_wait_ms.cnn",
                         "pad_share.cnn", "eval_rows.cnn"],
       "cnn-fedavg": ["host_train_enqueue_ms.fedavg", "host_wait_ms.fedavg",
                      "pad_share.fedavg"]}


class _Event:
    """A CPU stand-in for ``torch.cuda.Event``: host time at record."""

    def __init__(self, enable_timing=True):
        self.t = 0.0

    def record(self):
        import time
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


@pytest.fixture(scope="module", params=sorted(NEW))
def traced(request, tmp_path_factory):
    """A traced tiny run of the cell: (job, out, records, plans), the
    plans being every round's, in order."""
    mp = pytest.MonkeyPatch()
    torch.set_num_threads(2)
    mp.setattr(torch.cuda, "Event", _Event)
    plans = []

    def watch(fn):
        def wrapper(self, t, *args, **kwargs):
            plan = fn(self, t, *args, **kwargs)
            plans.append(plan)
            return plan
        return wrapper
    mp.setattr(RoundPlanner, "build", watch(RoundPlanner.build))
    mp.setattr(FedAvgServer, "_plan", watch(FedAvgServer._plan))
    telemetry.reset()
    job = tiny_job(request.param, tmp_path_factory.mktemp("run"))
    job.trace = True
    job.cell.traffic["trace_rounds"] = 2
    try:
        out = fl_cnn.run(job)
    finally:
        mp.undo()
    yield job, out, telemetry.records(), plans
    telemetry.reset()


def test_readers_take_the_windows_rounds(traced):
    job, out, recs, _ = traced
    ctx = out["ctx"]
    n, t = ctx["window"]["rounds"], ctx["traced"]["rounds"]
    setup = job.cell.traffic["setup_rounds"]
    assert n == len(out["walls"]) and t == 2
    assert len(recs) == setup + n + t
    assert [r.t for r in recs[:setup]] == list(range(1, setup + 1))
    win = recs[setup:setup + n]
    assert [r.seq for r in program.window(ctx)] == [r.seq for r in win]
    read = {m: cells.reader(m)(ctx) for m in NEW[job.cell.name]}
    assert set(read) <= {m["name"] for m in job.cell.per_layer}

    def mean(f):
        return sum(f(r) for r in win) / n

    def span_ms(name):
        return mean(lambda r: sum(s[3] - s[2] for s in r.spans
                                  if s[0] == name) * 1e-6)
    enqueue, wait = (read[m] for m in NEW[job.cell.name][:2])
    assert enqueue == pytest.approx(span_ms("launch/train"), rel=1e-12)
    assert wait == pytest.approx(span_ms("wait"), rel=1e-12)
    assert enqueue > 0 and wait > 0
    if "eval_rows.cnn" in read:
        assert read["eval_rows.cnn"] == mean(
            lambda r: r.counters["eval_rows"])
    # one record short of the window and the profiled rounds: nothing
    short = {"window": {"rounds": n + setup + 1}, "traced": {"rounds": t}}
    assert all(cells.reader(m)(short) is None for m in read)


def test_pad_share_is_the_bucket_arithmetic(traced):
    job, out, recs, plans = traced
    ctx = out["ctx"]
    n, setup = ctx["window"]["rounds"], job.cell.traffic["setup_rounds"]
    assert len(plans) == len(recs)
    pairs = [len(p.pair_model) for p in plans[setup:setup + n]]
    want = 100.0 * sum(bucket_size(b) - b for b in pairs) / sum(
        bucket_size(b) for b in pairs)
    name = [m for m in NEW[job.cell.name] if m.startswith("pad_share")][0]
    assert cells.reader(name)(ctx) == pytest.approx(want, rel=1e-12)


def test_nothing_to_read_without_the_telemetry(traced, monkeypatch):
    job, out, _, _ = traced
    monkeypatch.setitem(sys.modules, "repro_torch.telemetry", None)
    monkeypatch.delattr(repro_torch, "telemetry")
    for m in NEW[job.cell.name]:
        assert cells.reader(m)(out["ctx"]) is None
