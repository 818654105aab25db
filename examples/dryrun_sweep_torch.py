"""The dry run's sweep: every (arch x shape) of the port on the single-
and multi-pod production meshes, plus Qwen3-4B's ``decode_32k`` under
the ``decode_2d`` policy, each case a ``repro_torch.launch.dryrun``
process of its own with a time budget, ``--jobs`` at a time; then the
table of the results.

  PYTHONPATH=src python examples/dryrun_sweep_torch.py --jobs 8 \
      --out experiments/dryrun_torch/sweep
  PYTHONPATH=src python examples/dryrun_sweep_torch.py --table \
      --out experiments/dryrun_torch/sweep

A meta trace of a large model on a 16x16 mesh runs for minutes on one
core and holds several GB, so run the sweep on a host with the cores and
the memory (it needs no GPU). A case that a signal or the budget's outer
timeout ends leaves no JSON; the table lists it as such.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.config import INPUT_SHAPES  # noqa: E402
from repro_torch.configs import all_arch_names  # noqa: E402

MESHES = ("single", "multi")
EXTRA = [("qwen3-4b", "decode_32k", m, "_d2", ["--decode2d"])
         for m in MESHES]


def cases():
    out = [(a, s, m, "", []) for m in MESHES for a in all_arch_names()
           for s in INPUT_SHAPES]
    return out + EXTRA


def run(case, out_dir: str, budget: float) -> str:
    arch, shape, mesh, tag, extra = case
    t0 = time.time()
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh, "--budget", str(budget),
           "--out", out_dir, "--force"] + (["--tag", tag] if tag else []) \
        + extra
    try:
        p = subprocess.run(cmd, env=dict(os.environ, PYTHONPATH=os.path.join(
            ROOT, "src")), capture_output=True, text=True,
            timeout=budget + 120)
        last = p.stdout.strip().splitlines()[:1]
        rc = p.returncode
    except subprocess.TimeoutExpired:
        last, rc = ["killed at the outer timeout"], "timeout"
    return f"{arch} {shape} {mesh}{tag} rc={rc} wall={time.time() - t0:.1f}" \
        f" {last}"


def _gb(n: float) -> str:
    return f"{n / 1e9:.1f}"


def cell(out_dir: str, arch: str, shape: str, mesh: str, tag: str) -> str:
    """One case's result: trace s, dominant term, t_compute / t_memory /
    t_collective s, the busiest cell's argument + temp GB."""
    path = os.path.join(out_dir, f"{arch}_{shape}_{mesh}{tag}.json")
    if not os.path.exists(path):
        return "killed"
    with open(path) as f:
        r = json.load(f)
    if r.get("skipped"):
        return "skip"
    if not r["ok"]:
        return ("over budget" if "budget" in r["error"]
                else "fail: " + r["error"][:60])
    t, m = r["roofline"], r["memory"]
    dom = {"compute": "comp", "memory": "mem", "collective": "coll"}
    return (f"{r['trace_s']:.0f} s {dom[t['dominant']]} "
            f"{t['t_compute_s']:.2g}/{t['t_memory_s']:.2g}/"
            f"{t['t_collective_s']:.2g} {_gb(m['argument_bytes'])}+"
            f"{_gb(m['temp_bytes'])}")


def table(out_dir: str) -> str:
    """One row an arch, one column a shape; each cell ``single; multi``
    (the dominant term shortened)."""
    shapes = list(INPUT_SHAPES)
    rows = ["| arch | " + " | ".join(shapes) + " |",
            "| --- |" + " --- |" * len(shapes)]
    for arch in all_arch_names():
        rows.append(f"| {arch} | " + " | ".join(
            "; ".join(cell(out_dir, arch, s, m, "") for m in MESHES)
            for s in shapes) + " |")
    for arch, shape, mesh, tag, _ in EXTRA[:1]:
        rows.append(f"| {arch} decode_2d | " + " | ".join(
            "; ".join(cell(out_dir, arch, s, m, tag) for m in MESHES)
            if s == shape else "" for s in shapes) + " |")
    return "\n".join(rows)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="experiments/dryrun_torch/sweep")
    ap.add_argument("--jobs", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--budget", type=float, default=300.0)
    ap.add_argument("--table", action="store_true",
                    help="print the table of the results in --out")
    args = ap.parse_args()
    if args.table:
        print(table(args.out))
        return
    os.makedirs(args.out, exist_ok=True)
    t0 = time.time()
    with cf.ThreadPoolExecutor(args.jobs) as ex:
        for line in ex.map(lambda c: run(c, args.out, args.budget), cases()):
            print(line, flush=True)
    print(f"[sweep] {len(cases())} cases in {time.time() - t0:.0f} s",
          flush=True)


if __name__ == "__main__":
    main()
