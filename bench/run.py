"""Run one cell of the benchmark of ``repro_torch`` once.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Builds the cell from the files ``BENCHMARK.json`` names, warms it up
(``setup_s``), measures for ``--seconds``, checks what the program
produced against the plain reference, and prints one JSON line last on
standard output: the cell's end-to-end metrics (``--trace 0``) or its
per-layer metrics (``--trace 1``). Exits non-zero, with no result line,
without enough CUDA devices, or if the JAX package, ``jax``, ``jaxlib``
or ``flax`` was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(ROOT / "src"))
# one process with few threads: the host's share of a round is Python
# dispatch, which intra-op threads do not speed up but do disturb
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
# every cache of the run at a fixed place inside the checkout
os.environ.setdefault("PYTORCH_KERNEL_CACHE_PATH",
                      str(ROOT / "build" / "bench_cache" / "torch_kernels"))
os.environ.setdefault("USE_FLAX", "0")


@dataclass
class Job:
    cell: object
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float
    scratch: str


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch
    torch.set_num_threads(1)

    from fbench import cell as cells
    from fbench import result

    cell = cells.load_cell(args.workload)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.init()
    torch.cuda.reset_peak_memory_stats()
    runner = importlib.import_module(
        f"fbench.runners.{cell.config['runner']}")
    with tempfile.TemporaryDirectory(prefix="bench-") as scratch:
        out = runner.run(Job(cell, args.seed, args.seconds, bool(args.trace),
                             "cuda", T_START, scratch))
    found = result.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    correct, checks = result.verdict(out["numbers"], cell.limits)
    metrics = {}
    breakdown = None
    if args.trace:
        for m in cell.per_layer:
            v = cells.reader(m["name"])(out["ctx"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        tr = out["trace"]
        from fbench.profile import top
        breakdown = {"device_ops": top(tr["kernels"]),
                     "idle_gaps": top(tr["idle"])}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(out["end_to_end"][m["name"]]),
                                  "unit": m["unit"]}
    dev = result.device(cell.chips, out["memory_peak_bytes"],
                        out.get("trace") if args.trace else None)
    result.emit(correct, out["attempted"], out["failed"], metrics, dev,
                checks, breakdown)
    return 0


if __name__ == "__main__":
    sys.exit(main())
