"""The run's result: the device, the import check, the numbers that
decide ``correct`` beside their limits, and the last line."""
from __future__ import annotations

import json
import math
import subprocess
import sys
from typing import Any, Dict, List, Optional, Tuple

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole: ``repro_torch`` is not ``repro``."""
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout.strip()
        return float(out.splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def device(count: int, memory_peak_bytes: int,
           trace: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": count, "memory_peak_bytes": int(memory_peak_bytes),
           "power_limit_w": power_limit_w()}
    if trace is not None:
        out["busy_s"] = trace["busy_s"]
        out["window_s"] = trace["window_s"]
    return out


def emit(correct: bool, attempted: int, failed: int,
         metrics: Dict[str, Dict[str, Any]], dev: Dict[str, Any],
         checks: Dict[str, Dict[str, float]],
         breakdown: Optional[Dict[str, Any]] = None) -> None:
    """Each compared number beside its limit as the last lines on
    standard error, then the result as the last line of standard output
    (``checks`` its last key)."""
    for k, v in checks.items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(f"correct = {correct}", file=sys.stderr, flush=True)
    line: Dict[str, Any] = {"correct": bool(correct),
                            "attempted": int(attempted),
                            "failed": int(failed), "metrics": metrics,
                            "device": dev}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    print(json.dumps(line), flush=True)


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """correct, and each compared number beside its limit: a number
    passes at or under its limit, and a number that is not finite or is
    missing fails."""
    table = {k: {"value": float(numbers.get(k, math.nan)), "limit": lim}
             for k, lim in limits.items()}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in table.values())
    return ok, table
