#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU: builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds
each against its plain PyTorch version on the card, checks one MLP round
on the card against the same round on the CPU, then drives the main path
— FedCD (paper Algorithm 1, mode A) and the FedAvg baseline on the
paper's 10-layer CNN at full width, 30 devices — and reports which
kernels that run launched.

    python3 chip_smoke.py

Needs one CUDA GPU and ``nvcc``; exits non-zero without a result line
otherwise, and on any failed check. Phases print one line each; the last
line is a JSON object with ``"ok": true``. Float32 throughout with TF32
off for matrix products and convolutions.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and float32
# (non-tensor-core) FLOP/s — the bound of each kernel is the larger of
# its bytes over the first and its operations over the second
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

AGG_TOL = 1e-5                      # float32, different summation order
B_PAIRS = 32                        # work-batch width after the first clone
M_ROWS = (2, 16)                    # aggregated models: steady state, m_cap
RAGGED = [(1, 5, 1), (17, 5, 3), (3, 33, 10), (16, 7, 1027),
          (2, 32, 2303)]            # (M, B, D) off the float4 path
SMOKE_ROUNDS = 6                    # passes milestone 5: a quantized clone
# the paper config's lr (0.08) sends this CNN to NaN within a round on
# the synthetic data, in the JAX reference as well; 0.01 stays finite
CNN_LR = 0.01


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean milliseconds of ``fn()`` on the card's clock (CUDA events
    around ``reps`` eager calls, after a warm-up). Includes the host's
    launch gaps when the host is slower than the device."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Mean device milliseconds of ``fn()``: its launches captured once
    in a CUDA graph and replayed, so no host launch gap is counted."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm-up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, reps)


def timings(kernel, plain, library=None):
    """Device (graph-replay) and eager times of a kernel, its plain
    version and the library call."""
    return dict(ms=graph_ms(kernel), eager_ms=cuda_ms(kernel),
                plain_ms=graph_ms(plain), plain_eager_ms=cuda_ms(plain),
                library_ms=None if library is None else graph_ms(library))


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def unaligned(shape, gen, device):
    """A contiguous float32 tensor whose data pointer is not 16-byte
    aligned (the kernels' scalar path)."""
    import torch
    n = int(np.prod(shape))
    buf = torch.randn(n + 1, generator=gen, device=device)
    return buf[1:].view(shape)


def check_kernels(device, leaf_sizes):
    """Phase 3: every kernel against its plain version on the card."""
    import torch

    from repro_torch.kernels.quantize import ops as qops
    from repro_torch.kernels.quantize.ref import (dequantize_ref,
                                                  quantize_ref)
    from repro_torch.kernels.weighted_agg import ops as wops
    from repro_torch.kernels.weighted_agg.ref import multi_weighted_agg_ref

    gen = torch.Generator(device=device).manual_seed(0)
    rows = {}
    for m in M_ROWS:
        us = [torch.randn(B_PAIRS, d, generator=gen, device=device)
              for d in leaf_sizes]
        w = torch.rand(m, B_PAIRS, generator=gen, device=device)
        w[:, -5:] = 0.0                           # padding pairs
        den = torch.clamp(w.sum(1), min=1e-12)
        err = max(float((wops.multi_weighted_agg(u, w, den)
                         - multi_weighted_agg_ref(u, w, den)).abs().max())
                  for u in us)
        if not err <= AGG_TOL:
            fail(f"multi_weighted_agg M={m}: max_abs_err {err} > {AGG_TOL}")
        ws = (w / den[:, None]).contiguous()
        t = timings(lambda: [wops.multi_weighted_agg(u, w, den) for u in us],
                    lambda: [multi_weighted_agg_ref(u, w, den) for u in us],
                    lambda: [torch.mm(ws, u) for u in us])
        nbytes = sum((B_PAIRS * d + m * B_PAIRS + m * d) * 4
                     for d in leaf_sizes)
        flops = sum(2 * m * B_PAIRS * d for d in leaf_sizes)
        b_ms, b_by = bound(nbytes, flops)
        rows[("multi_weighted_agg", m)] = dict(
            max_abs_err=err, bound_ms=b_ms, bound_by=b_by, **t)

        # transport roundtrip of the M aggregated rows, one launch per leaf
        xs = [torch.randn(m, d, generator=gen, device=device) * 0.1
              for d in leaf_sizes]
        q_err = s_err = d_err = 0.0
        mism = 0
        for x in xs:
            q, s = qops.quantize(x, 8)
            qr, sr = quantize_ref(x, 8)
            dq = (q.int() - qr.int()).abs()
            q_err = max(q_err, float(dq.max()))
            mism += int((dq != 0).sum())
            s_err = max(s_err, float(((s - sr).abs() / sr).max()))
            if float(dq.max()) > 1 or float((dq != 0).float().mean()) >= 1e-3:
                fail(f"quantize M={m} n={x.shape[1]}: codes off the bar")
            if not s_err <= 1e-6:
                fail(f"quantize M={m}: scale rel err {s_err} > 1e-6")
            out = qops.dequantize(qr, sr, x.shape[1])
            ref = dequantize_ref(qr, sr, tuple(x.shape), torch.float32)
            d_err = max(d_err, float((out - ref).abs().max()))
            if d_err != 0.0:
                fail(f"dequantize M={m} n={x.shape[1]}: max_abs_err {d_err}")
        packed = [qops.quantize(x, 8) for x in xs]
        t_q = timings(lambda: [qops.quantize(x, 8) for x in xs],
                      lambda: [quantize_ref(x, 8) for x in xs])
        t_d = timings(lambda: [qops.dequantize(q, s, x.shape[1])
                               for (q, s), x in zip(packed, xs)],
                      lambda: [dequantize_ref(q, s, tuple(x.shape),
                                              torch.float32)
                               for (q, s), x in zip(packed, xs)])
        pads = [-(-d // 128) * 128 for d in leaf_sizes]
        q_bytes = sum(m * (4 * d + p + p // 32)
                      for d, p in zip(leaf_sizes, pads))
        n_vals = sum(m * d for d in leaf_sizes)
        # per value: abs, max, divide, round, two clamps / one multiply
        qb, qby = bound(q_bytes, 6 * n_vals)
        db, dby = bound(q_bytes, n_vals)
        rows[("quantize", m)] = dict(
            max_abs_err=q_err, bound_ms=qb, bound_by=qby,
            code_mismatches=mism, scale_rel_err=s_err, **t_q)
        rows[("dequantize", m)] = dict(
            max_abs_err=d_err, bound_ms=db, bound_by=dby, **t_d)

    # ragged and unaligned shapes: the scalar paths and M > 16 chunks
    for m, b, d in RAGGED:
        u = unaligned((b, d), gen, device)
        w = torch.rand(m, b, generator=gen, device=device)
        den = torch.clamp(w.sum(1), min=1e-12)
        err = float((wops.multi_weighted_agg(u, w, den)
                     - multi_weighted_agg_ref(u, w, den)).abs().max())
        if not err <= AGG_TOL:
            fail(f"multi_weighted_agg ragged {(m, b, d)}: {err}")
        x = unaligned((m, d), gen, device)
        for bits in (4, 8):
            q, s = qops.quantize(x, bits)
            qr, sr = quantize_ref(x, bits)
            dq = (q.int() - qr.int()).abs()
            if (float(dq.max()) > 1 or float((dq != 0).float().mean()) >= 1e-3
                    or float(((s - sr).abs() / sr).max()) > 1e-6):
                fail(f"quantize ragged {(m, d)} bits={bits}: off the bar")
            if not torch.equal(qops.dequantize(qr, sr, d),
                               dequantize_ref(qr, sr, (m, d),
                                              torch.float32)):
                fail(f"dequantize ragged {(m, d)} bits={bits}: mismatch")
    torch.cuda.synchronize()
    return rows


def mlp_card_vs_cpu(device):
    """Phase 4: one MLP round (and the milestone clone after it) of the
    port on the card against the same round on the CPU."""
    import torch

    from repro_torch.configs.fedcd_cifar import HIERARCHICAL
    from repro_torch.core.fedcd import FedCDServer
    from repro_torch.data.partition import hierarchical_devices, stack_devices
    from repro_torch.models.mlp import (init_mlp_classifier, mlp_accuracy,
                                        mlp_loss)

    data = stack_devices(hierarchical_devices(
        seed=0, devices_per_archetype=1, n_train=64, n_val=32, n_test=32))
    cfg = dataclasses.replace(HIERARCHICAL, n_devices=10,
                              devices_per_round=5, milestones=(1,),
                              max_models=8)
    params = init_mlp_classifier(torch.Generator().manual_seed(0),
                                 hidden=32)
    srv = {dev: FedCDServer(cfg, params, mlp_loss, mlp_accuracy, data,
                            batch_size=16, device=dev)
           for dev in (device, "cpu")}
    for s in srv.values():
        s.run_round(1)
    card, host = srv[device], srv["cpu"]
    if card.registry.live_ids() != host.registry.live_ids():
        fail("MLP round: live models differ between card and CPU")
    err = max(float((card.registry.params.tree[k][m].cpu()
                     - host.registry.params.tree[k][m]).abs().max())
              for m in host.registry.live_ids()
              for k in host.registry.params.tree)
    if not err <= AGG_TOL:
        fail(f"MLP round: bank rows differ by {err} > {AGG_TOL}")
    vc, vh = card.executor._val_cache, host.executor._val_cache
    if sorted(vc) != sorted(vh) or not all(np.array_equal(vc[m], vh[m])
                                           for m in vh):
        fail("MLP round: val accuracy matrices differ")
    return err


def main_path(device):
    """Phase 5: FedCD and FedAvg on the paper's CNN, 30 devices at the
    partition's default sizes, int8 transport."""
    import torch

    from repro_torch.configs.fedcd_cifar import HIERARCHICAL
    from repro_torch.core.fedavg import FedAvgServer
    from repro_torch.core.fedcd import FedCDServer
    from repro_torch.data.partition import hierarchical_devices, stack_devices
    from repro_torch.models.cnn import cnn_accuracy, cnn_loss, init_cnn

    data = stack_devices(hierarchical_devices(seed=0))
    cfg = dataclasses.replace(HIERARCHICAL, quantize_bits=8, lr=CNN_LR)
    params = init_cnn(torch.Generator().manual_seed(0))
    fedcd = FedCDServer(cfg, params, cnn_loss, cnn_accuracy, data,
                        batch_size=32, device=device)
    fedavg = FedAvgServer(cfg, params, cnn_loss, cnn_accuracy, data,
                          batch_size=32, device=device)
    walls = []
    for t in range(1, SMOKE_ROUNDS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = fedcd.run_round(t)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        a = fedavg.run_round(t)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        walls.append((t1 - t0, t2 - t1))
        print(f"[round {t}] fedcd wall_s={t1 - t0:.4f} "
              f"test_acc={m.test_acc.mean():.4f} live={m.live_models} "
              f"active={m.active_models} | fedavg wall_s={t2 - t1:.4f} "
              f"test_acc={a.test_acc.mean():.4f}", flush=True)
        if not (np.isfinite(m.test_acc).all() and np.isfinite(a.test_acc).all()):
            fail(f"round {t}: non-finite accuracy")
    if fedcd.metrics[4].live_models < 2:
        fail("fewer than 2 live models after round 5")
    for name, tree in (("fedcd", fedcd.registry.params.tree),
                       ("fedavg", fedavg.params)):
        if not all(bool(torch.isfinite(v).all()) for v in tree.values()):
            fail(f"{name}: non-finite params after {SMOKE_ROUNDS} rounds")
    return walls


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.quantize import ops as qops
    from repro_torch.kernels.weighted_agg import ops as wops
    from repro_torch.models.cnn import init_cnn

    device = torch.device("cuda")
    # phase 1: the card, and full float32 for products and convolutions
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    card_line = smi.stdout.strip().splitlines()[0]
    print(card_line)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[tf32] torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}"
          f" torch={torch.__version__} cuda={torch.version.cuda}")

    # phase 2: build every kernel source, all nvcc processes at once
    t0 = time.perf_counter()
    built = build.build()
    print(f"[build] {len(built)} libraries in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, (_, log) in built.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}")

    # phase 3: kernels against their plain versions at the main path's
    # shapes (the CNN's 20 leaves) and at ragged ones
    leaves = [v.numel() for v in init_cnn(torch.Generator()).values()]
    rows = check_kernels(device, leaves)
    for (name, m), r in rows.items():
        extra = "".join(f" {k}={r[k]}" for k in ("code_mismatches",
                                                 "scale_rel_err") if k in r)
        print(f"[kernel {name} M={m} B={B_PAIRS} leaves={len(leaves)}] "
              f"max_abs_err={r['max_abs_err']} ms={r['ms']:.5f} "
              f"eager_ms={r['eager_ms']:.5f} plain_ms={r['plain_ms']:.5f} "
              f"plain_eager_ms={r['plain_eager_ms']:.5f} "
              f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']}) "
              f"library_ms={r['library_ms']}{extra}")

    # phase 4: one MLP round on the card against the CPU
    err = mlp_card_vs_cpu(device)
    print(f"[mlp card-vs-cpu] bank max_abs_err={err} val matrices equal")

    # phase 5: the main path, with every launch counter from zero
    counters = (wops.multi_weighted_agg, qops.quantize, qops.dequantize)
    for fn in counters:
        fn.launches = 0
    walls = main_path(device)
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"[main path] fedcd mean wall_s rounds 2-{SMOKE_ROUNDS}="
          f"{np.mean([w[0] for w in walls[1:]]):.4f} fedavg="
          f"{np.mean([w[1] for w in walls[1:]]):.4f} launches={launches}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")

    meta = {
        "multi_weighted_agg": ("csrc/weighted_agg.cu",
                               "src/repro/kernels/weighted_agg/kernel.py:77"),
        "quantize": ("csrc/quantize.cu",
                     "src/repro/kernels/quantize/kernel.py:48"),
        "dequantize": ("csrc/quantize.cu",
                       "src/repro/kernels/quantize/kernel.py:74"),
    }
    kernels = []
    for name, (src, replaces) in meta.items():
        r = rows[(name, M_ROWS[0])]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/{src}", "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
