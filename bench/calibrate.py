"""Readings for the limits of ``correct`` (a tool for the chip; the
benchmark's own runs never run it).

    python3 bench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--variants sound,control,half,answer,stale] [--detail]

For each seed: the cell's set-up as a run makes it, on the card, from
the cell's own files (no window), then the numbers that decide
``correct`` for each variant put in the program's place: ``sound`` (the
program itself), ``control`` (the reference in TF32, the precision
below the configuration's float32), ``half`` (the reference
aggregating half of each model's pairs), ``answer`` (the reference with
one model's validation row shifted by a device), ``stale`` (the
reference taking every step's gradient at the pair's starting params).
One JSON line per seed and variant.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent / "src"))


class Job:
    def __init__(self, cell, seed, scratch):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, 0.0, False
        self.device, self.t_start, self.scratch = ("cuda", time.perf_counter(),
                                                   scratch)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variants", default="sound,control,half,answer,stale")
    p.add_argument("--detail", action="store_true")
    args = p.parse_args()
    import importlib

    import torch

    from fbench import cell as cells

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    cell = cells.load_cell(args.workload)
    runner = importlib.import_module(f"fbench.runners.{cell.config['runner']}")
    tf32 = bool(cell.config["model"].get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    for seed in (int(s) for s in args.seeds.split(",")):
        with tempfile.TemporaryDirectory() as scratch:
            job = Job(cell, seed, scratch)
            ses = runner.Session(job, cell.config, cell.traffic)
            t0 = time.perf_counter()
            recs = ses.setup(os.path.join(scratch, "round_state"))
            setup = time.perf_counter() - t0
            for variant in args.variants.split(","):
                detail = [] if args.detail else None
                t0 = time.perf_counter()
                nums = ses.check(recs, tf32=(variant == "control"),
                                 fault=("" if variant in ("sound",
                                                          "control")
                                        else variant),
                                 detail=detail)
                line = {"workload": args.workload, "seed": seed,
                        "variant": variant, "numbers": nums,
                        "setup_s": setup,
                        "check_s": time.perf_counter() - t0}
                if detail:
                    detail.sort(key=lambda d: -d[2])
                    line["worst"] = [[str(d[0])] + list(d[1:])
                                     for d in detail[:12]]
                print(json.dumps(line), flush=True)
            ses.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
