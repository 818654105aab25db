"""Where one FedCD round's time goes on the GPU (PyTorch/CUDA port).

Runs the ``chip_smoke.py`` main-path configuration — the paper's CNN,
``fedcd_cifar.HIERARCHICAL`` at 30 devices, int8 transport, lr 0.01,
batch 32 — through round 5 (so two models live), then measures rounds
6 to 8:

* per phase of the fused round (train, aggregate + transport, scatter,
  val/test eval): device time between CUDA events at the phase's ends;
* the round's host wall time;
* in a third, profiled round (torch profiler): the device's busy time
  (the union of kernel intervals) over the window from its first to its
  last kernel — the idle share — and the kernels with the most device
  time.

  PYTHONPATH=src python examples/profile_round_torch.py
"""
import dataclasses
import time
from collections import defaultdict

import torch

import repro_torch.federated.simulation as sim
from repro_torch.configs.fedcd_cifar import HIERARCHICAL
from repro_torch.core.fedcd import FedCDServer
from repro_torch.data.partition import hierarchical_devices, stack_devices
from repro_torch.models.cnn import cnn_accuracy, cnn_loss, init_cnn

PHASES = defaultdict(list)        # phase -> [device ms per call]


def timed(name, fn):
    """Wrap ``fn`` so each call records its device span in PHASES."""
    def wrapper(*args, **kwargs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = fn(*args, **kwargs)
        end.record()
        PHASES[name].append((start, end))
        return out
    return wrapper


def main() -> None:
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
    srv = FedCDServer(cfg, init_cnn(torch.Generator().manual_seed(0)),
                      cnn_loss, cnn_accuracy, data, batch_size=32)
    for t in range(1, 6):
        srv.run_round(t)
    torch.cuda.synchronize()
    PHASES.clear()

    walls = []
    for t in (6, 7):                      # phases, without the profiler
        t0 = time.perf_counter()
        m = srv.run_round(t)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        print(f"round {t}: live={m.live_models} "
              f"test_acc={m.test_acc.mean():.4f} wall_ms={walls[-1]:.3f}")
    for name, spans in PHASES.items():
        ms = sum(s.elapsed_time(e) for s, e in spans) / len(walls)
        print(f"[phase] {name}: {ms:.3f} ms per round "
              f"({len(spans) / len(walls):.0f} calls)")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        srv.run_round(8)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, None, None
    for s0, e0 in spans:                  # union of kernel intervals
        if cur_e is None or s0 > cur_e:
            busy += 0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += 0 if cur_e is None else cur_e - cur_s
    window = spans[-1][1] - spans[0][0] if spans else 0.0
    print(f"[round 8, profiled] device busy {busy / 1e3:.3f} ms of a "
          f"{window / 1e3:.3f} ms first-to-last-kernel window: idle share "
          f"{1 - busy / window:.3f} ({len(kernels)} kernels)")
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"[kernel] {us / 1e3:9.3f} ms x{n:6d}  {name[:90]}")


if __name__ == "__main__":
    main()
