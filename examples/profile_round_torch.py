"""Where one FedCD round's time goes on the GPU (PyTorch/CUDA port),
synchronous and pipelined.

Runs the ``chip_smoke.py`` main-path configuration — the paper's CNN,
``fedcd_cifar.HIERARCHICAL`` at 30 devices, int8 transport, lr 0.01,
batch 32 — once per engine spec (``--specs``, default ``fused`` and
``fused+pipeline``), up to the profiled round ``--round`` R (default 9:
two models live after the clone of round 5; 4 reads a one-model round):

* rounds R-3 and R-2, no profiler: each phase of the fused round (train,
  aggregate + transport, scatter, val/test eval) as device time between
  CUDA events at the phase's ends, and each round's host wall (a sync
  round is drained before its wall is read; a pipelined round returns
  with the next round's training on the card, so its wall runs from one
  ``run_round`` return to the next);
* rounds R-1 and R under the torch profiler; round R is read (R-1 is
  traced so that the speculative training it enqueues is in the trace):
  - the device's busy time (the union of kernel and copy intervals)
    inside round R's host window, from ``run_round``'s entry to its
    return, and the idle share of that window; also the idle share of
    the window from the first to the last kernel that ran in it;
  - the device's idle time split by what the host was doing meanwhile
    (the innermost of: enqueueing training, launch, speculate,
    readback, collect, planning, else the lifecycle and the rest);
  - the host's time in each of those phases;
  - every CUDA runtime call of round R that took over 50 us on the
    host (a synchronisation, a blocking copy, a pinned allocation), by
    name and phase;
  - the kernels with the most device time.

The profiler itself slows the host's enqueue, so the profiled rounds'
walls are longer than the unprofiled ones.

  PYTHONPATH=src python examples/profile_round_torch.py
      [--specs fused,fused+pipeline] [--round 9]
"""
import argparse
import dataclasses
import time
from collections import defaultdict

import torch

import repro_torch.federated.simulation as sim
from repro_torch.configs.fedcd_cifar import HIERARCHICAL
from repro_torch.core.fedcd import FedCDServer
from repro_torch.data.partition import hierarchical_devices, stack_devices
from repro_torch.models.cnn import cnn_accuracy, cnn_loss, init_cnn

PHASES = defaultdict(list)        # phase -> [(start, end) CUDA events]
# host phases, innermost first: a moment belongs to the first one open
HOST_PHASES = ("train enqueue", "launch", "speculate", "readback",
               "collect", "plan")
SLOW_CALL_US = 50.0


def timed(name, fn):
    """Wrap ``fn`` so each call records its device span in PHASES and
    its host span as a profiler range (train only: the innermost host
    phase)."""
    def wrapper(*args, **kwargs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        if name == "train":
            with torch.profiler.record_function("train enqueue"):
                out = fn(*args, **kwargs)
        else:
            out = fn(*args, **kwargs)
        end.record()
        PHASES[name].append((start, end))
        return out
    return wrapper


def labelled(label, fn):
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)
    return wrapper


def instrument(srv):
    """Label the server's host phases for the profiler."""
    ex, planner = srv.executor, srv.planner
    ex.launch = labelled("launch", ex.launch)
    ex.speculate = labelled("speculate", ex.speculate)
    ex.readback = labelled("readback", ex.readback)
    ex.collect = labelled("collect", ex.collect)
    planner.build = labelled("plan", planner.build)
    planner.build_speculative = labelled("plan", planner.build_speculative)


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


def phase_at(t, ranges):
    for label in HOST_PHASES:
        if any(s <= t < e for s, e in ranges.get(label, ())):
            return label
    return "lifecycle+other"


def analyse(prof, spec, r):
    events = prof.events()
    cpu = torch.autograd.DeviceType.CPU
    labels = set(HOST_PHASES) | {"round"}
    rounds = sorted((e.time_range.start, e.time_range.end) for e in events
                    if e.name == "round" and e.device_type == cpu)
    w0, w1 = rounds[-1]                              # round r's host window
    ranges = defaultdict(list)
    for e in events:
        if e.name in HOST_PHASES and e.device_type == cpu:
            s0, e0 = max(e.time_range.start, w0), min(e.time_range.end, w1)
            if s0 < e0:
                ranges[e.name].append((s0, e0))
    # kernels and copies; a labelled range also has a device-side twin
    # spanning its work on the card, which is not device work itself
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.name not in labels]
    inside = [(max(e.time_range.start, w0), min(e.time_range.end, w1))
              for e in device
              if e.time_range.end > w0 and e.time_range.start < w1]
    busy, merged = union(inside)
    window = w1 - w0
    first, last = (merged[0][0], merged[-1][1]) if merged else (w0, w0)
    print(f"[{spec} round {r}, profiled] host wall {window / 1e3:.3f} ms; "
          f"device busy {busy / 1e3:.3f} ms in it: idle share "
          f"{1 - busy / window:.3f} of the round's host window, "
          f"{1 - busy / max(last - first, 1e-9):.3f} of its first-to-last-"
          f"kernel window ({(last - first) / 1e3:.3f} ms; {len(inside)} "
          f"device events)")
    # the device's idle time, by what the host was doing meanwhile
    cuts = sorted({w0, w1, *(t for spans in ranges.values()
                             for span in spans for t in span)})
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
            idle[phase_at((a + b) / 2, ranges)] += b - a
    print(f"[{spec} round {r} device idle by host phase] " + " ".join(
        f"{k}={v / 1e3:.3f}ms" for k, v in sorted(idle.items(),
                                                  key=lambda kv: -kv[1])))
    host = {k: union(v)[0] for k, v in ranges.items()}
    print(f"[{spec} round {r} host ms by phase] " + " ".join(
        f"{k}={host.get(k, 0.0) / 1e3:.3f}" for k in HOST_PHASES))
    slow = defaultdict(lambda: [0, 0.0, 0.0])
    for e in events:
        if (e.device_type == cpu and e.name.startswith("cuda")
                and w0 <= e.time_range.start < w1
                and e.time_range.elapsed_us() > SLOW_CALL_US):
            key = (e.name, phase_at(e.time_range.start, ranges))
            slow[key][0] += 1
            slow[key][1] += e.time_range.elapsed_us()
            slow[key][2] = max(slow[key][2], e.time_range.elapsed_us())
    if not slow:
        print(f"[{spec} round {r} runtime calls > {SLOW_CALL_US:.0f} us] none")
    for (name, phase), (n, us, top) in sorted(slow.items(),
                                              key=lambda kv: -kv[1][1]):
        print(f"[{spec} round {r} runtime calls > {SLOW_CALL_US:.0f} us] "
              f"{name} in {phase}: {n} calls, {us / 1e3:.3f} ms, "
              f"max {top / 1e3:.3f} ms")
    by_name = defaultdict(lambda: [0.0, 0])
    for e in device:
        if e.time_range.end > w0 and e.time_range.start < w1:
            by_name[e.name][0] += e.time_range.elapsed_us()
            by_name[e.name][1] += 1
    for name, (us, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:8]:
        print(f"[{spec} kernel] {us / 1e3:9.3f} ms x{n:6d}  {name[:90]}")


def profile(spec, data, cfg, r):
    PHASES.clear()
    srv = FedCDServer(cfg, init_cnn(torch.Generator().manual_seed(0)),
                      cnn_loss, cnn_accuracy, data, batch_size=32,
                      spec=spec, device=torch.device("cuda"))
    pipelined = srv.pipeline
    instrument(srv)
    for t in range(1, r - 3):
        srv.run_round(t)
    torch.cuda.synchronize()
    PHASES.clear()

    t0 = time.perf_counter()
    for t in (r - 3, r - 2):              # phases, without the profiler
        m = srv.run_round(t)
        if not pipelined:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        print(f"[{spec} round {t}] live={m.live_models} "
              f"test_acc={m.test_acc.mean():.4f} "
              f"wall_ms={(t1 - t0) * 1e3:.3f}")
        t0 = t1
    torch.cuda.synchronize()
    for name, spans in PHASES.items():
        ms = sum(s.elapsed_time(e) for s, e in spans) / 2
        print(f"[{spec} phase] {name}: {ms:.3f} ms per round "
              f"({len(spans) / 2:.1f} calls)")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for t in (r - 1, r):
            with torch.profiler.record_function("round"):
                srv.run_round(t)
            if not pipelined:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
    analyse(prof, spec, r)
    if pipelined:
        print(f"[{spec}] pipeline_stats={srv.pipeline_stats.as_dict()}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--specs", default="fused,fused+pipeline",
                        help="comma-separated engine specs to profile")
    parser.add_argument("--round", type=int, default=9,
                        help="the round to profile (at least 4)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pair_train = sim._pair_train
    sim._pair_train = lambda loss, lr: timed("train", pair_train(loss, lr))
    sim._aggregate_rows = timed("aggregate+transport", sim._aggregate_rows)
    sim._scatter_rows = timed("scatter", sim._scatter_rows)
    sim._eval_gathered = timed("eval", sim._eval_gathered)

    data = stack_devices(hierarchical_devices(seed=0))
    cfg = dataclasses.replace(HIERARCHICAL, quantize_bits=8, lr=0.01)
    for spec in args.specs.split(","):
        profile(spec, data, cfg, max(args.round, 4))


if __name__ == "__main__":
    main()
