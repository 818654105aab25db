"""Where one FedCD round's time goes on the GPU (PyTorch/CUDA port),
synchronous and pipelined, read from the program's own round telemetry
(``repro_torch.telemetry``: each round's host spans and counters, on the
profiler's clock).

Runs the ``chip_smoke.py`` main-path configuration — the paper's CNN,
``fedcd_cifar.HIERARCHICAL`` at 30 devices, int8 transport, lr 0.01,
batch 32 — once per engine spec (``--specs``, default ``fused`` and
``fused+pipeline``), up to the profiled round ``--round`` R (default 9:
two models live after the clone of round 5; 4 reads a one-model round):

* rounds R-3 and R-2, no profiler: each round's host wall (a sync round
  is drained before its wall is read; a pipelined round returns with
  the next round's training on the card, so its wall runs from one
  ``run_round`` return to the next), and its record: each span's host
  self time and the counters;
* rounds R-1 and R under the torch profiler; round R is read (R-1 is
  traced so that the speculative training it enqueues is in the trace):
  - the device's busy time (the union of kernel and copy intervals)
    inside round R's ``round`` span, and the idle share of that span;
    also the idle share of the window from the first to the last kernel
    that ran in it;
  - the device's idle time split by the innermost program span open
    meanwhile (``launch/train``, ``readback/wait``, ``collect``, ...);
  - every CUDA runtime call of round R that took over 50 us on the
    host (a synchronisation, a blocking copy, a pinned allocation), by
    name and innermost span;
  - the kernels with the most device time.

The profiler itself slows the host's enqueue, so the profiled rounds'
walls are longer than the unprofiled ones. ``--jsonl PATH`` writes every
round record (``telemetry.write_jsonl``) at the end.

  PYTHONPATH=src python examples/profile_round_torch.py
      [--specs fused,fused+pipeline] [--round 9] [--jsonl rounds.jsonl]
"""
import argparse
import dataclasses
import time
from collections import defaultdict

import torch

from repro_torch import telemetry
from repro_torch.configs.fedcd_cifar import HIERARCHICAL
from repro_torch.core.fedcd import FedCDServer
from repro_torch.data.partition import hierarchical_devices, stack_devices
from repro_torch.models.cnn import cnn_accuracy, cnn_loss, init_cnn

SLOW_CALL_US = 50.0


def union(spans):
    """Total length of the union of (start, end) intervals, and the
    merged intervals."""
    merged = []
    for s0, e0 in sorted(spans):
        if merged and s0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e0)
        else:
            merged.append([s0, e0])
    return sum(e - s for s, e in merged), merged


def labels(rec):
    """Each span's label: its name, a ``wait`` prefixed by its parent's."""
    out = []
    for name, parent, _, _ in rec.spans:
        out.append(f"{out[parent]}/wait" if name == "wait" else name)
    return out


def span_at(t, rec, names):
    """The innermost span of ``rec`` open at ``t`` (the latest started:
    spans nest)."""
    inner = None
    for i, (_, _, t0, t1) in enumerate(rec.spans):
        if t0 <= t < t1:
            inner = i
    return names[inner] if inner is not None else "outside"


def report_record(rec, tag):
    names = labels(rec)
    own = defaultdict(float)
    for name, ns in zip(names, rec.self_ns()):
        own[name] += ns * 1e-6
    print(f"[{tag} host self ms by span] " + " ".join(
        f"{k}={v:.3f}" for k, v in sorted(own.items(),
                                          key=lambda kv: -kv[1])))
    print(f"[{tag} counters] {rec.counters}")


def analyse(prof, rec, spec, r):
    names = labels(rec)
    w0, w1 = rec.spans[0][2], rec.spans[0][3]       # round r's host span
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    device = [(e.start_ns(), e.end_ns(), e.name()) for e in events
              if e.device_type() == cuda and not e.is_user_annotation()]
    inside = [(max(s, w0), min(e, w1)) for s, e, _ in device
              if e > w0 and s < w1]
    busy, merged = union(inside)
    window = w1 - w0
    first, last = (merged[0][0], merged[-1][1]) if merged else (w0, w0)
    print(f"[{spec} round {r}, profiled] host wall {window / 1e6:.3f} ms; "
          f"device busy {busy / 1e6:.3f} ms in it: idle share "
          f"{1 - busy / window:.3f} of the round's span, "
          f"{1 - busy / max(last - first, 1e-9):.3f} of its first-to-last-"
          f"kernel window ({(last - first) / 1e6:.3f} ms; {len(inside)} "
          f"device events)")
    # the device's idle time, by the innermost program span meanwhile
    cuts = sorted({t for _, _, t0, t1 in rec.spans for t in (t0, t1)})
    gaps, prev = [], w0
    for s0, e0 in merged:
        if s0 > prev:
            gaps.append((prev, s0))
        prev = max(prev, e0)
    if prev < w1:
        gaps.append((prev, w1))
    idle = defaultdict(float)
    for g0, g1 in gaps:
        points = [g0] + [c for c in cuts if g0 < c < g1] + [g1]
        for a, b in zip(points, points[1:]):
            idle[span_at((a + b) / 2, rec, names)] += b - a
    print(f"[{spec} round {r} device idle by program span] " + " ".join(
        f"{k}={v / 1e6:.3f}ms" for k, v in sorted(idle.items(),
                                                  key=lambda kv: -kv[1])))
    report_record(rec, f"{spec} round {r}, profiled")
    slow = defaultdict(lambda: [0, 0.0, 0.0])
    for e in events:
        us = (e.end_ns() - e.start_ns()) / 1e3
        if (e.device_type() != cuda and e.name().startswith("cuda")
                and w0 <= e.start_ns() < w1 and us > SLOW_CALL_US):
            key = (e.name(), span_at(e.start_ns(), rec, names))
            slow[key][0] += 1
            slow[key][1] += us
            slow[key][2] = max(slow[key][2], us)
    if not slow:
        print(f"[{spec} round {r} runtime calls > {SLOW_CALL_US:.0f} us] none")
    for (name, where), (n, us, top) in sorted(slow.items(),
                                              key=lambda kv: -kv[1][1]):
        print(f"[{spec} round {r} runtime calls > {SLOW_CALL_US:.0f} us] "
              f"{name} in {where}: {n} calls, {us / 1e3:.3f} ms, "
              f"max {top / 1e3:.3f} ms")
    by_name = defaultdict(lambda: [0.0, 0])
    for s, e, name in device:
        if e > w0 and s < w1:
            by_name[name][0] += (e - s) / 1e3
            by_name[name][1] += 1
    for name, (us, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:8]:
        print(f"[{spec} kernel] {us / 1e3:9.3f} ms x{n:6d}  {name[:90]}")


def profile(spec, data, cfg, r):
    srv = FedCDServer(cfg, init_cnn(torch.Generator().manual_seed(0)),
                      cnn_loss, cnn_accuracy, data, batch_size=32,
                      spec=spec, device=torch.device("cuda"))
    pipelined = srv.pipeline
    for t in range(1, r - 3):
        srv.run_round(t)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for t in (r - 3, r - 2):              # records, without the profiler
        m = srv.run_round(t)
        if not pipelined:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        print(f"[{spec} round {t}] live={m.live_models} "
              f"test_acc={m.test_acc.mean():.4f} "
              f"wall_ms={(t1 - t0) * 1e3:.3f}")
        report_record(telemetry.records()[-1], f"{spec} round {t}")
        t0 = t1
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for t in (r - 1, r):
            srv.run_round(t)
            if not pipelined:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
    analyse(prof, telemetry.records()[-1], spec, r)
    if pipelined:
        print(f"[{spec}] pipeline_stats={srv.pipeline_stats.as_dict()}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--specs", default="fused,fused+pipeline",
                        help="comma-separated engine specs to profile")
    parser.add_argument("--round", type=int, default=9,
                        help="the round to profile (at least 4)")
    parser.add_argument("--jsonl", default=None,
                        help="write every round record here at the end")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    data = stack_devices(hierarchical_devices(seed=0))
    cfg = dataclasses.replace(HIERARCHICAL, quantize_bits=8, lr=0.01)
    for spec in args.specs.split(","):
        profile(spec, data, cfg, max(args.round, 4))
    if args.jsonl:
        n = telemetry.write_jsonl(args.jsonl)
        print(f"[records] {n} lines in {args.jsonl}")


if __name__ == "__main__":
    main()
