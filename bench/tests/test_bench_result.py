"""The result line, the verdict and the import check."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from fbench import result

ROOT = Path(__file__).resolve().parents[2]


def test_last_line_keys(capsys):
    checks = {"grad_gap": {"value": 1e-7, "limit": 1e-4}}
    result.emit(True, 24, 0, {"round_ms": {"value": 1.5, "unit": "ms"}},
                {"platform": "gpu", "kind": "x", "count": 1,
                 "memory_peak_bytes": 3}, checks,
                {"device_ops": [["k", 0.1]], "idle_gaps": [["plan", 0.2]]})
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert line["checks"] == checks
    assert err.strip().splitlines()[-2].startswith("check grad_gap = ")
    assert err.strip().splitlines()[-1] == "correct = True"


def test_verdict():
    limits = {"a": 1.0, "b": 0}
    assert result.verdict({"a": 1.0, "b": 0.0}, limits)[0]
    assert not result.verdict({"a": 1.1, "b": 0.0}, limits)[0]
    assert not result.verdict({"a": float("nan"), "b": 0.0}, limits)[0]
    ok, table = result.verdict({"b": 0.0}, limits)     # a number missing
    assert not ok and table["b"] == {"value": 0.0, "limit": 0}


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", object())
    assert "repro" not in result.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert "repro" in result.forbidden_modules()


def test_import_graph_has_no_jax(tmp_path):
    """A whole CNN run on the CPU (tiny), the metric readers and the
    entry point loaded: nothing of JAX or the JAX package."""
    code = f"""
import sys
sys.path[:0] = [{str(ROOT / 'bench')!r}, {str(ROOT / 'bench' / 'tests')!r},
                {str(ROOT / 'src')!r}]
import runpy, torch
torch.set_num_threads(2)
runpy.run_path({str(ROOT / 'bench' / 'run.py')!r}, run_name="bench_run")
from bench_helpers import tiny_job
from fbench import cell, result
from fbench.runners import fl_cnn
job = tiny_job("cnn-fedavg", {str(tmp_path)!r})
job.cell.traffic["check_rounds"] = [1]
fl_cnn.run(job)
for m in cell.load_benchmark()["per_layer"]:
    cell.reader(m["name"])
print("FORBIDDEN", result.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout


def test_no_card_no_result():
    """Without a CUDA device the command exits non-zero and prints no
    result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "cnn-fedavg",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


class _Event:
    """A CPU stand-in for ``torch.cuda.Event``: host time at record."""

    def __init__(self, enable_timing=True):
        self.t = 0.0

    def record(self):
        import time
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_traced_run_plumbing(monkeypatch, tmp_path):
    """A traced run end to end on the CPU: the window's spans, the
    profiled rounds' reduction and every reader of the cell (the device
    trace is empty here, so the rooflines read nothing)."""
    import torch

    from bench_helpers import tiny_job
    from fbench import cell as cells
    from fbench.runners import fl_cnn
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    job = tiny_job("cnn-fedcd-r16", tmp_path)
    job.trace = True
    job.cell.traffic["trace_rounds"] = 2
    out = fl_cnn.run(job)
    ctx = out["ctx"]
    assert ctx["window"]["rounds"] == len(out["walls"]) == 3
    assert ctx["window"]["plan_ms"] > 0 and ctx["window"]["train_ms"] > 0
    assert ctx["window"]["flops"] > 0
    assert out["trace"]["rounds"] == 2 and out["trace"]["window_s"] > 0
    assert len(out["trace"]["eq1"]) == 2 and out["trace"]["quant"]
    read = {m["name"]: cells.reader(m["name"])(ctx)
            for m in job.cell.per_layer}
    assert read["weighted_agg_roofline"] is None
    assert read["idle_share.cnn"] == pytest.approx(100.0)
    assert read["mfu.cnn"] > 0 and read["host_plan_ms.cnn"] > 0
