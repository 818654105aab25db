#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU: builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds
each against its plain PyTorch version on the card (phase 3b: the CNN's
3x3 convolution kernels at each layer of the pair step, G=64 pairs of 32
images, against float64 and timed beside their bound, the plain version
and cuDNN's call; FedAvg's 16 pairs and the eval's fold of 30 x 128
images against float64), checks one MLP round
on the card against the same round on the CPU, then drives the main path
— FedCD (paper Algorithm 1, mode A) and the FedAvg baseline on the
paper's 10-layer CNN at full width, 30 devices, fused engine — checks
that the legacy, batched and fused engines agree on the card, and drives
the legacy and batched engines at the same full width, then the
pipelined fused path (``fused+pipeline``: round t+1's training enqueued
before round t's readback) for FedCD and FedAvg and FedCD with holder-
only validation scoring (``fused+pipeline+sparse:1.1``) at the same full
width. Each path reports which kernels it launched (on every CNN path
the three convolution kernels must launch, or the run fails); the
pipelined path
also reports in how many rounds the readback returned while the next
round's speculative training was still running on the card. Last, the
overlap check runs 3 pipelined rounds of FedCD and of FedAvg with a
fixed device spin enqueued after each speculation: a readback that
waited on the stream would return after the spin in every round, and
the run fails then. Phases 10-12 run semi-synchronous rounds, device
churn and crash-and-resume; phase 13 runs the sharded planes
(``sharded@1``, ``@4``, ``@2x2``, ``@2x2+pipeline``, ``@4`` with a forced
row migration; FedAvg ``@4`` and ``@2x2``), every cell of a mesh on the
one card, each against a ``fused`` run with its launch counts predicted.
Phase 14 drives the mode-B LM trainer (``FedLLMTrainer``, the dense GQA
family): reduced Qwen3-4B on the card against the CPU, the ``legacy``
and ``llm+pipeline`` engines and a crash-and-resume against ``llm`` on
the card, one train step with int8 gradient transport through the
transport kernels against their plain versions (one launch of each per
step), then Qwen3-4B at every published width (bf16, d_model 2560, vocab
151936; its depth cut 36 -> 12) for 4 rounds on ``llm`` and on
``legacy``, with per-round walls, tokens/s, the train/eval split and the
peak memory. Phase 15 does the
same for the MoE and MLA families: reduced Phi-3.5-MoE and reduced
DeepSeek-V3 (MLA, a shared expert, the MTP head) on the card against the
CPU, ``legacy`` and ``llm+pipeline`` equal to ``llm`` and a crash resumed
from its checkpoint, DeepSeek-V3's int8 gradient transport step (46
leaves: two launches of each kernel), then Phi-3.5-MoE at every
published width with its depth cut to 2 layers (``llm`` and ``legacy``)
and DeepSeek-V3 at its widest single-card tier (4 layers, 16 of its 256
experts; ``llm``). Phase 16 does the same for the recurrent families at
seq 24 (two mLSTM / SSD chunks of 16, the second padded): reduced
xlstm-125m (an mLSTM and an sLSTM segment) and reduced Zamba2 (Mamba2
groups, the shared attention block with per-site LoRA) on the card
against the CPU, ``legacy`` / ``llm+pipeline`` / crash-and-resume equal
to ``llm``, the int8 gradient transport of reduced Zamba2 (31 leaves:
one launch of each kernel) and of xlstm-125m whole (54 leaves: two),
then xlstm-125m whole (12 layers, d_model 768, vocab 50304) and Zamba2-7B
at every published width with its depth cut 81 -> 25 (4 sites of 6
Mamba2 layers and a tail layer), each on ``llm`` and ``legacy``. Phase 17
drives the decode path: the four tiny decoder configs of the serving
tests (dense with a sliding window, MLA, xLSTM, the Zamba2 hybrid) and
reduced whisper-small on the card against the CPU (chunked prefill with
a padded tail, decode steps, caches; rollback after a speculative verify
bitwise equal to the prefill of the accepted prefix), then whisper-small
whole (bf16: train steps at 4 x 2 x 448 tokens on 1500 source frames,
the encoder's share, an eval, an int8 gradient transport step, a greedy
decode of 64 tokens) and Qwen3-4B at phase 14's tier (a 2048-token
prefill at B=8 and 64 decode steps, held against the teacher-forced
forward). Phase 18 drives the serving plane (``repro_torch.serve``):
TINY and the four tiny configs, each a two-model population with
synthetic scores, through the gateway's vanilla, speculative (a 1-layer
draft, k=3), paged int8 and speculative+paged modes on the card and on
the CPU — greedy streams card == CPU and every mode == vanilla, pages
and lanes all returned after the drain — then Qwen3-4B at phase 14's
tier: the LM trainer with 2-layer draft rows trains phase 14's FedCD
configuration until two models are live, a gateway of 8 lanes serves 16
requests of 128-token prompts and 32 new tokens in the vanilla, spec and
paged modes (TTFT, tokens/s, dispatches, batching efficiency,
acceptance, KV bytes, agreement with vanilla), then one more round, a
``sync`` and a second batch. No serving path launches a kernel. Phase
19 drives the tensor-parallel LM mesh (``FedLLMTrainer(mesh=...)``,
every cell of the mesh on the one card): 19.1, float32, the tiny LM and
reduced Phi-3.5-MoE over 8 rounds on ``model=2`` and ``model=2,
data=2`` meshes against the one-device run on the card (but MoE at
``data=2``, whose capacity follows the reference's mesh run) and the
same mesh on the CPU, and the int8 gradient transport step of the tiny
LM and of reduced Qwen3-4B on both meshes (launches predicted from the
pieces' layout, codes against the plain versions and against the whole
leaves' quantization);
19.2, Qwen3-4B at phase 14's tier (12 of 36 layers, bf16) on ``llm`` at
``model=2`` for 3 rounds, its step ms, round walls, peak memory and
losses beside phase 14's one-device run. Phase 20 drives the decode
path on the mesh (``mesh=`` on the prefill, serve, verify and propose
steps and the gateway over a sharded bank, every cell on the one card):
20.1, float32, reduced Qwen3-4B, Phi-3.5-MoE, DeepSeek-V3, xLSTM and
Zamba2 through a chunked prefill (the last chunk padded), decode steps,
a verify with a partial accept and a propose on ``model=2`` and
``model=2, data=2`` against the one-device run on the card and the same
mesh on the CPU, and a tiny population trained on ``model=2`` served in
the four gateway modes, its streams equal to the one-device gateway's on
the bank gathered; 20.2, Qwen3-4B at phase 14's tier from the bank phase
19.2 trained, a 512-token prompt at B=8 and 32 greedy decode steps on
``model=2`` and on one device, then one gateway batch from the mesh bank
and from the bank gathered (prefill tokens/s, decode ms and aten
operators a token, peak memory, the share of greedy tokens equal, each
differing token classified by its top-2 logit gap against the bf16
noise). Phase 21 holds the dry run (``repro_torch.launch.dryrun``)
against the card: 21.1, float32, params laid out by the ``decode_2d``
policy on ``model=2, data=2`` and the ``pod`` meshes (``dp_axes=("pod",
"data")``) for reduced Qwen3-4B and Phi-3.5-MoE against the one-device
run; 21.2, Qwen3-4B at phase 14's tier, one train step (the default
remat) on one device and on ``model=2`` beside the dry run's trace of the
same step on ``meta`` cells: the FLOPs the port's counter reads on the
card must equal the prediction, as must the collectives by cell; the
peak against ``max_memory_allocated``, the step's device ms and its
share of the bf16 peak are printed. Each phase ends in an
``[elapsed]`` line with the script's wall clock.

    python3 chip_smoke.py

Needs one CUDA GPU and ``nvcc``; exits non-zero without a result line
otherwise, and on any failed check. Phases print one line each; the last
line is a JSON object with ``"ok": true``. Float32 throughout with TF32
off for matrix products and convolutions, except the full-width models
of phases 14-17, which are bf16 as registered (their float32 products,
the MoE routers and the recurrences' float32 leaves among them, still
without TF32).
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
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
N_DEVICES = 30                      # the legacy engine's eq-1 rows
SMALL_LEAF = 10_000                 # the CNN's 13 leaves below it
RAGGED_SINGLE = [(1, 5), (3, 17), (7, 1027), (30, 2303)]   # (N, D)
RAGGED_DEQ = [(1, 128, 128), (5, 2304, 64), (30, 384, 128),
              (4, 192, 64)]         # (N, D, block)
MIXED_DEQ_BLOCKS = [1, 3, 18, 5, 4608, 7, 32, 2]   # leaf lengths in blocks
ENGINE_ROUNDS = 8                   # the engine-agreement phase (MLP)
# the fused engine's pipelined and sparse specs, held to "fused" (MLP)
PIPELINE_SPECS = ("fused+pipeline", "fused+sparse:1.1",
                  "fused+pipeline+sparse:0.9")
OVERLAP_ROUNDS = 3                  # the overlap check: 2 speculations used
HOLD_CYCLES = 40_000_000            # its device spin, ~20-40 ms a round
# semi-synchronous rounds (phase 10): the default straggler model of
# "+semisync", synchronous and pipelined; and a run in which every
# device's update of round DROP_ROUND is lost (nothing aggregates)
SEMISYNC_SPECS = ("fused+semisync", "fused+pipeline+semisync")
DROP_ROUNDS = 4
DROP_ROUND = 3
# device churn (phase 11): random_churn over the 30 devices with these
# rates joins, leaves and drifts within SMOKE_ROUNDS rounds and reuses a
# freed data row (a leave and a join in round 3)
CHURN_SEED = 3
CHURN_RATES = dict(join_rate=0.6, leave_rate=0.6, drift_rate=0.5)
CHURN_SPECS = ("fused", "fused+pipeline", "fused+sparse:1.1")
# crash and resume (phase 12): a checkpoint every CKPT_EVERY rounds; the
# mid-save crash on a save round, every other phase the round after it,
# so a resume replays an unsaved round
CKPT_EVERY = 2
RESUME_PATHS = (
    ("fedcd fused", "fedcd", "fused", (
        (4, "mid-save"), (5, "post-plan"), (5, "mid-dispatch"),
        (5, "post-readback"))),
    ("fedcd fused+pipeline", "fedcd", "fused+pipeline",
     ((5, "mid-dispatch"),)),
    ("fedcd fused+semisync", "fedcd", "fused+semisync",
     ((5, "post-readback"),)),
    ("fedcd fused+pipeline churn", "fedcd", "churn", ((5, "post-plan"),)),
    ("fedavg fused+pipeline", "fedavg", "fused+pipeline",
     ((5, "post-plan"),)),
)
# the sharded planes (phase 13): (name, server, (model, data) shards,
# variant), every cell of a mesh on the one card; "migrate" moves the
# newest live model to the next shard after round MIGRATE_AFTER
SHARDED_PATHS = (
    ("fedcd sharded@1", "fedcd", (1, 1), None),
    ("fedcd sharded@4", "fedcd", (4, 1), None),
    ("fedcd sharded@2x2", "fedcd", (2, 2), None),
    ("fedcd sharded@2x2+pipeline", "fedcd", (2, 2), "pipeline"),
    ("fedcd sharded@4 migrate", "fedcd", (4, 1), "migrate"),
    ("fedavg sharded@4", "fedavg", (4, 1), None),
    ("fedavg sharded@2x2", "fedavg", (2, 2), None),
)
MIGRATE_AFTER = 3
# predicted launches of (multi_weighted_agg, quantize, dequantize) on each
# path (PERF.md, written before the first run): model 0 aggregates alone
# in rounds 1-5 and its milestone-5 clone, placed on another model shard,
# beside it in round 6. On a 1-D mesh eq 1 is one kernel launch per model
# shard with aggregation work (5 + 2 on four shards); with a data axis
# eq 1 is the plain data-axis sum and makes none. The transport is one
# roundtrip per model shard with work, plus the clone's.
SHARDED_LAUNCHES = {
    "fedcd sharded@1": (6, 7, 7),
    "fedcd sharded@4": (7, 8, 8),
    "fedcd sharded@2x2": (0, 8, 8),
    "fedcd sharded@2x2+pipeline": (0, 8, 8),
    "fedcd sharded@4 migrate": (7, 8, 8),
    "fedavg sharded@4": (0, 0, 0),
    "fedavg sharded@2x2": (0, 0, 0),
}
# the CPU tiers' bars against the fused run: params within two int8 steps
# (FedCD's int8 transport), float32 allclose at 1e-5 (FedAvg)
SHARDED_INT8_TOL = 2 / 127
SHARDED_F32_TOL = 1e-5
MIXED_LEAVES = [10, 2303, 4096, 129, 5, 1027, 589_824, 1, 128]
BACK_TO_BACK = 20                   # calls captured in one graph
# the paper config's lr (0.08) sends this CNN to NaN within a round on
# the synthetic data, in the JAX reference as well; 0.01 stays finite
CNN_LR = 0.01
# the mode-B LM trainer (phase 14): card against CPU, the engines and the
# gradient transport at reduced width on the FedCD configuration of
# tests/test_llm_equivalence.py; then Qwen3-4B at full width, bf16
LM_ARCH = "qwen3-4b"
LM_CLIENTS, LM_PER, LM_SEQ, LM_ROUNDS = 4, 2, 16, 8
LM_FED = dict(n_devices=4, devices_per_round=3, score_window=2,
              milestones=(2, 5), late_delete_round=6, max_models=6,
              lr=0.05, seed=0)
LM_HIST_TOL = 1e-6                  # score history, card against CPU
LM_PARAM_TOL = 1e-4                 # params, card against CPU (float32)
LM_CKPT_EVERY, LM_CRASH = 2, (4, "mid-dispatch")
LM_TRANSPORT = (8, 2, 128)          # clients, per client, seq (phase 14.3)
FULL_LM_FED = dict(n_devices=8, devices_per_round=4, milestones=(2,),
                   max_models=4, lr=0.01, late_delete_round=8)
FULL_LM_CLIENTS, FULL_LM_PER, FULL_LM_SEQ, FULL_LM_ROUNDS = 8, 2, 128, 4
# Qwen3-4B's tier at every published width, its depth cut 36 -> 12 to
# keep the script under 600 s with phase 16 (PERF.md section 4)
FULL_LM_CUT = {"n_layers": 12}
# the MoE / MLA / MTP families (phase 15): the reduced configs on phase
# 14's FedCD configuration and dims; DeepSeek-V3's gradient transport
# (46 leaves of 128 values or more, 32 a launch: 2 launches of each
# kernel a step); then each at full width, as (arch, what is cut,
# engines): every published width kept; Phi-3.5-MoE's depth 4 -> 2 since
# phase 19 (the script's time)
MOE_ARCHS = ("phi3.5-moe-42b-a6.6b", "deepseek-v3-671b")
MOE_TRANSPORT = ("deepseek-v3-671b", 2)
FULL_MOE = (("phi3.5-moe-42b-a6.6b", {"n_layers": 2}, ("llm", "legacy")),
            ("deepseek-v3-671b", {"n_layers": 4, "moe.n_experts": 16},
             ("llm",)))
# the Mamba2 / xLSTM / hybrid families (phase 16): the reduced configs on
# phase 14's FedCD configuration at seq 24 (two chunks of 16, the second
# padded: 16 would be one chunk, without a carried state); the gradient
# transport (arch, reduced, predicted launches of each kernel: 32 leaves
# a launch) of reduced Zamba2 (31 leaves) and of xlstm-125m whole (54);
# then xlstm-125m whole and Zamba2-7B at every published width, its
# depth cut to the deepest 6k+1 predicted under ~70 GB (PERF.md)
SSM_ARCHS = ("xlstm-125m", "zamba2-7b")
SSM_SEQ = 24
SSM_TRANSPORT = (("zamba2-7b", True, 1), ("xlstm-125m", False, 2))
FULL_SSM = (("xlstm-125m", None, ("llm", "legacy")),
            ("zamba2-7b", {"n_layers": 25}, ("llm", "legacy")))
# the decode path (phase 17): the four tiny configs of
# tests/test_gateway.py:37-55 and reduced whisper-small on the card against
# the CPU (float32): an 11-token prompt in chunks of 4 (the last padded),
# then 8 decode steps (whisper: its caches, then 8 decode steps); a verify
# of a 4-token chunk whose draft is rejected at its second token
DECODE_B, DECODE_PROMPT, DECODE_CHUNK, DECODE_STEPS, DECODE_MAXLEN = (
    2, 11, 4, 8, 24)
DECODE_LOGIT_TOL = 1e-5             # logits, card against CPU
DECODE_CACHE_TOL = 1e-6             # cache floats, of each leaf's scale
# whisper-small whole (phase 17.2), bf16 as registered: 4 clients x 2
# rows x 448 target tokens (Whisper's published decoder context) on 1500
# source frames, per-layer recompute; a greedy decode of 64 tokens at B=8
WHISPER = "whisper-small"
WHISPER_DIMS = (4, 2, 448)
WHISPER_STEPS = 3                   # timed train steps, after a warm-up
WHISPER_DECODE = 64
# Qwen3-4B at phase 14's tier (phase 17.3): a 2048-token prompt at B=8 in
# chunks of 512, then 64 greedy decode steps, held against the
# teacher-forced forward over the same 2112 tokens
QWEN_DECODE = (8, 2048, 512, 64)    # batch, prompt, chunk, new tokens
QWEN_AGREE = 0.95                   # argmax agreement with the forward
# the serving plane (phase 18): TINY and the four tiny configs of
# tests/test_gateway.py:37-55, each a two-model population (init_lm of seed
# 0 and a perturbed clone, synthetic scores), on the card and on the CPU
# (float32) in every gateway mode; then Qwen3-4B at phase 14's tier (bf16)
# served from a FedCD population the LM trainer trains on phase 14's
# configuration, with draft rows
SERVE_MODES = (("vanilla", {}), ("spec", dict(spec_k=3, draft_layers=1)),
               ("paged", dict(paged=True, page_slots=8)),
               ("spec+paged", dict(spec_k=3, draft_layers=1, paged=True,
                                   page_slots=8)))
SERVE_SMALL = (8, 10, 6)            # requests (one a device), prompt, new
SERVE_SMALL_GW = dict(max_len=64, lanes=4, chunk=8)
SERVE_SHRINK = 3.5                  # dense f32 KV over paged int8 (TINY)
SERVE_DRAFT_LAYERS = 2              # the trainer's draft rows (phase 18.2)
SERVE_FULL_GW = dict(max_len=256, lanes=8, chunk=64)
SERVE_FULL = (16, 128, 32)          # requests (two a device), prompt, new
# the tensor-parallel LM mesh (phase 19): (model, data) meshes with every
# cell on the one card; the tiny LM of tests/test_llm_equivalence.py and
# reduced Phi-3.5-MoE on phase 14's FedCD configuration (float32), the
# transport step on the tiny LM (pieces that cut its 128-value blocks:
# gathered) and on reduced Qwen3-4B (every piece whole blocks: alone),
# then Qwen3-4B at phase 14's tier
MESH_SHAPES = ((2, 1), (2, 2))
MESH_ARCHS = ("tiny", "phi3.5-moe-42b-a6.6b")
MESH_PARAM_TOL = 1e-5               # params, mesh against one device
MESH_TRANSPORT_ARCHS = ("tiny", LM_ARCH)
MESH_FULL_MODEL, MESH_FULL_ROUNDS = 2, 3
MESH_LOSS_TOL = 0.05                # bf16 losses, mesh against one device
SERVE_FULL_MODES = (("vanilla", {}), ("spec", dict(spec_k=3)),
                    ("paged", dict(paged=True, page_slots=8)))
# the decode path on the mesh (phase 20): the five reduced families on
# MESH_SHAPES (float32; 4 rows and chunks of 4: no MoE capacity drops a
# token, so data=2 keeps the one-device values) against one device and
# the CPU mesh at phase 17's bars; the tiny LM trained on model=2 and
# served in the four gateway modes; then Qwen3-4B at phase 14's tier
MESH_DECODE_ARCHS = ("qwen3-4b", "phi3.5-moe-42b-a6.6b", "deepseek-v3-671b",
                     "xlstm-125m", "zamba2-7b")
MESH_DECODE = (4, 11, 4, 4, 24)     # batch, prompt, chunk, decodes, max len
# reduced Zamba2's caches, card mesh against the CPU mesh: the port's CPU
# run sits 1.06e-6 of the scale of ``shared.k`` from the card's and from
# the reference's (float32 rounding of the shared block at d_model 256;
# phase 17's bar was set on d_model 64); against one device on the card
# every family is held at DECODE_CACHE_TOL
MESH_DECODE_CPU_CACHE_TOL = {"zamba2-7b": 2e-6}
MESH_SERVE_ROUNDS = 5
MESH_SERVE_MODES = (("vanilla", {}), ("spec", dict(spec_k=3)),
                    ("paged", dict(paged=True, page_slots=8)),
                    ("spec+paged", dict(spec_k=3, paged=True,
                                        page_slots=8)))
MESH_QWEN = (8, 512, 32)            # batch, prompt, greedy decode steps
MESH_QWEN_GW = dict(max_len=256, lanes=8, chunk=64)
MESH_QWEN_SERVE = (8, 128, 32)      # requests, prompt, new tokens
# the dry run against the card (phase 21): 21.1 the decode_2d and pod
# layouts of tests/test_torch_dryrun.py on reduced Qwen3-4B and
# Phi-3.5-MoE (float32; Phi with a capacity no batch here fills) against
# the one-device run, every cell on the card; 21.2 Qwen3-4B at phase 14's
# tier, one train step (default remat) on one device and on model=2 of
# the card beside the dry run's trace of that step on meta cells
DRY_ARCHS = ("qwen3-4b", "phi3.5-moe-42b-a6.6b")
DRY_DECODE = (4, 4, 4)                   # batch, prompt, decode steps
DRY_POD_MESHES = ((2, 2, 1), (2, 1, 2))  # pod, data, model
DRY_MODEL = 2
DRY_PEAK_TOL = 0.10                      # predicted peak against the card


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


def leaf_diagnostics(sizes, nbytes, group, library=None):
    """Where an eq-1 call's time goes: the largest leaf alone (device ms
    and its stream rate against HBM_BYTES_PER_S) and the leaves under
    SMALL_LEAF values together, each as one grouped kernel call and, given
    ``library``, as the library calls, on graph replay. ``group(idx)``
    calls the kernel over the leaves ``idx``, ``library(i)`` the library
    over leaf i; ``nbytes[i]`` is what leaf i moves."""
    big = max(range(len(sizes)), key=lambda i: sizes[i])
    small = [i for i, d in enumerate(sizes) if d < SMALL_LEAF]
    big_ms = graph_ms(lambda: group([big]))
    out = dict(big_d=sizes[big], big_ms=big_ms,
               big_gb_s=nbytes[big] / big_ms * 1e-6,
               big_hbm_share=nbytes[big] / (big_ms * 1e-3) / HBM_BYTES_PER_S)
    if library is not None:
        out["big_library_ms"] = graph_ms(lambda: library(big))
    out.update(small_leaves=len(small),
               small_ms=graph_ms(lambda: group(small)))
    if library is not None:
        out["small_library_ms"] = graph_ms(lambda: [library(i) for i in small])
    return out


def check_transport(xs, qs, ss, bits, tag):
    """Hold a quantize call's codes ``qs`` and scales ``ss`` of the
    leaves ``xs`` to the reference's bar against the plain version (codes
    at most one step off on fewer than 1e-3 of the values, scales to rtol
    1e-6), and a dequantize_group call over the plain version's codes to
    exactness. Returns (max code diff, code mismatches, max scale rel err,
    max dequantize abs err)."""
    import torch

    from repro_torch.kernels.quantize import ops as qops
    from repro_torch.kernels.quantize.ref import (dequantize_ref,
                                                  quantize_ref)
    refs = [quantize_ref(x, bits) for x in xs]
    q_err = s_err = d_err = 0.0
    mism = 0
    for x, q, s, (qr, sr) in zip(xs, qs, ss, refs):
        if q.shape != qr.shape or s.shape != sr.shape:
            fail(f"quantize {tag} n={x.shape[1]}: shapes {tuple(q.shape)}, "
                 f"{tuple(s.shape)}")
        dq = (q.int() - qr.int()).abs()
        q_err = max(q_err, float(dq.max()) if dq.numel() else 0.0)
        mism += int((dq != 0).sum())
        if dq.numel() and (float(dq.max()) > 1
                           or float((dq != 0).float().mean()) >= 1e-3):
            fail(f"quantize {tag} n={x.shape[1]}: codes off the bar")
        if s.numel():
            s_err = max(s_err, float(((s - sr).abs() / sr).max()))
        if not s_err <= 1e-6:
            fail(f"quantize {tag}: scale rel err {s_err} > 1e-6")
    outs = qops.dequantize_group([qr for qr, _ in refs],
                                 [sr for _, sr in refs],
                                 [x.shape[1] for x in xs])
    for x, out, (qr, sr) in zip(xs, outs, refs):
        ref = dequantize_ref(qr, sr, tuple(x.shape), torch.float32)
        if out.shape != ref.shape or not torch.equal(out, ref):
            fail(f"dequantize {tag} n={x.shape[1]}: mismatch")
        if out.numel():
            d_err = max(d_err, float((out - ref).abs().max()))
    return q_err, mism, s_err, d_err


def transport_diagnostics(sizes, nbytes, group, call, one_block):
    """Where a transport call's time goes, on graph replay: the largest
    leaf alone (device ms and its stream rate against HBM_BYTES_PER_S),
    the leaves under SMALL_LEAF values together in one launch, the whole
    call when BACK_TO_BACK of it are replayed from one graph (per call:
    no gap between replays), and ``one_block`` (the kernel's launch over
    one 128-value block, the floor under any of its launches) alone and
    back to back."""
    big = max(range(len(sizes)), key=lambda i: sizes[i])
    small = [i for i, d in enumerate(sizes) if d < SMALL_LEAF]
    big_ms = graph_ms(lambda: group([big]))
    return dict(
        big_n=sizes[big], big_ms=big_ms,
        big_gb_s=nbytes[big] / big_ms * 1e-6,
        big_hbm_share=nbytes[big] / (big_ms * 1e-3) / HBM_BYTES_PER_S,
        small_leaves=len(small), small_ms=graph_ms(lambda: group(small)),
        back_to_back_ms=graph_ms(lambda: [call() for _ in range(
            BACK_TO_BACK)]) / BACK_TO_BACK,
        one_block_ms=graph_ms(one_block),
        one_block_back_to_back_ms=graph_ms(lambda: [one_block() for _ in
                                                    range(BACK_TO_BACK)])
        / BACK_TO_BACK)


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
        # the path's call: every leaf in one grouped call; and each leaf
        # through the per-leaf wrapper (a group of one)
        outs = wops.multi_weighted_agg_group(us, w, den)
        err = max(float((o - multi_weighted_agg_ref(u, w, den)).abs().max())
                  for u, o in zip(us, outs))
        err = max([err] + [float((wops.multi_weighted_agg(u, w, den)
                                  - multi_weighted_agg_ref(u, w, den))
                                 .abs().max()) for u in us])
        if not err <= AGG_TOL:
            fail(f"multi_weighted_agg M={m}: max_abs_err {err} > {AGG_TOL}")
        ws = (w / den[:, None]).contiguous()
        t = timings(lambda: wops.multi_weighted_agg_group(us, w, den),
                    lambda: [multi_weighted_agg_ref(u, w, den) for u in us],
                    lambda: [torch.mm(ws, u) for u in us])
        nbytes = sum((B_PAIRS * d + m * B_PAIRS + m * d) * 4
                     for d in leaf_sizes)
        flops = sum(2 * m * B_PAIRS * d for d in leaf_sizes)
        b_ms, b_by = bound(nbytes, flops)
        rows[("multi_weighted_agg", m)] = dict(
            max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
            diag=leaf_diagnostics(
                leaf_sizes, [(B_PAIRS * d + m * B_PAIRS + m + m * d) * 4
                             for d in leaf_sizes],
                lambda idx: wops.multi_weighted_agg_group(
                    [us[i] for i in idx], w, den),
                lambda i: torch.mm(ws, us[i])), **t)

        # transport roundtrip of the M aggregated rows: the path's call is
        # one quantize_group and one dequantize_group over every leaf; each
        # leaf also through the per-leaf wrappers (groups of one)
        xs = [torch.randn(m, d, generator=gen, device=device) * 0.1
              for d in leaf_sizes]
        qs, ss = qops.quantize_group(xs, 8)
        q_err, mism, s_err, d_err = check_transport(xs, qs, ss, 8,
                                                    f"M={m}")
        for x in xs:
            check_transport([x], *[[t] for t in qops.quantize(x, 8)], 8,
                            f"M={m} per-leaf")
        ns = [x.shape[1] for x in xs]
        t_q = timings(lambda: qops.quantize_group(xs, 8),
                      lambda: [quantize_ref(x, 8) for x in xs])
        t_d = timings(lambda: qops.dequantize_group(qs, ss, ns),
                      lambda: [dequantize_ref(q, s, tuple(x.shape),
                                              torch.float32)
                               for q, s, x in zip(qs, ss, xs)],
                      lambda: [torch.mul(q.view(m, -1, 128), s.unsqueeze(-1))
                               for q, s in zip(qs, ss)])
        x1 = torch.randn(1, 128, generator=gen, device=device)
        q1, s1 = qops.quantize_group([x1], 8)
        pads = [-(-d // 128) * 128 for d in leaf_sizes]
        q_bytes = [m * (4 * d + p + p // 32)
                   for d, p in zip(leaf_sizes, pads)]
        n_vals = sum(m * d for d in leaf_sizes)
        # per value: abs, max, divide, round, two clamps / one multiply
        qb, qby = bound(sum(q_bytes), 6 * n_vals)
        db, dby = bound(sum(q_bytes), n_vals)
        rows[("quantize", m)] = dict(
            max_abs_err=q_err, bound_ms=qb, bound_by=qby,
            code_mismatches=mism, scale_rel_err=s_err,
            diag=transport_diagnostics(
                leaf_sizes, q_bytes,
                lambda idx: qops.quantize_group([xs[i] for i in idx], 8),
                lambda: qops.quantize_group(xs, 8),
                lambda: qops.quantize_group([x1], 8)), **t_q)
        rows[("dequantize", m)] = dict(
            max_abs_err=d_err, bound_ms=db, bound_by=dby,
            diag=transport_diagnostics(
                leaf_sizes, q_bytes,
                lambda idx: qops.dequantize_group(
                    [qs[i] for i in idx], [ss[i] for i in idx],
                    [ns[i] for i in idx]),
                lambda: qops.dequantize_group(qs, ss, ns),
                lambda: qops.dequantize_group(q1, s1, [128])), **t_d)

    # ragged and unaligned shapes: the scalar paths and the extra passes
    # over U of M > 8
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
            check_transport([x], *[[t] for t in qops.quantize(x, bits)],
                            bits, f"ragged {(m, d)}")
    # aligned, unaligned and ragged leaves in one grouped call
    xs = [unaligned((3, d), gen, device) if i % 2 else
          torch.randn(3, d, generator=gen, device=device)
          for i, d in enumerate(MIXED_LEAVES)]
    for bits in (4, 8):
        check_transport(xs, *qops.quantize_group(xs, bits), bits,
                        f"mixed group bits={bits}")
    torch.cuda.synchronize()
    return rows


def check_single_kernels(device, leaf_sizes):
    """Phase 3, continued: the single-model eq-1 kernel over float32 and
    over int8 payloads (weighted_agg, dequant_agg) against their plain
    versions, each as one grouped call at the legacy path's shapes (N =
    30 device rows over the CNN's 20 leaves), and at ragged and unaligned
    shapes."""
    import torch

    from repro_torch.kernels.quantize import ops as qops
    from repro_torch.kernels.weighted_agg import ops as wops
    from repro_torch.kernels.weighted_agg.ref import (dequant_agg_ref,
                                                      weighted_agg_ref)

    gen = torch.Generator(device=device).manual_seed(1)
    n = N_DEVICES
    w = torch.rand(n, generator=gen, device=device)
    w[::2] = 0.0                                  # non-holders
    den = torch.clamp(w.sum(), min=1e-12)
    us = [torch.randn(n, d, generator=gen, device=device)
          for d in leaf_sizes]
    outs = wops.weighted_agg_group(us, w, den)      # the path's call
    err = max(float((o - weighted_agg_ref(u, w, den)).abs().max())
              for u, o in zip(us, outs))
    err = max([err] + [float((wops.weighted_agg(u, w, den)
                              - weighted_agg_ref(u, w, den)).abs().max())
                       for u in us])
    if not err <= AGG_TOL:
        fail(f"weighted_agg N={n}: max_abs_err {err} > {AGG_TOL}")
    ws = (w / den).contiguous()
    t = timings(lambda: wops.weighted_agg_group(us, w, den),
                lambda: [weighted_agg_ref(u, w, den) for u in us],
                lambda: [torch.mv(u.t(), ws) for u in us])
    nbytes = sum((n * d + n + 1 + d) * 4 for d in leaf_sizes)
    b_ms, b_by = bound(nbytes, sum(2 * n * d for d in leaf_sizes))
    rows = {("weighted_agg", n): dict(
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
        diag=leaf_diagnostics(
            leaf_sizes, [(n * d + n + 1 + d) * 4 for d in leaf_sizes],
            lambda idx: wops.weighted_agg_group([us[i] for i in idx], w, den),
            lambda i: torch.mv(us[i].t(), ws)), **t)}

    # the path's call over int8 payloads: codes and scales from the
    # quantize kernel, as the transport makes them, every leaf in one
    # grouped call (one launch); and each leaf through the per-leaf
    # wrapper (a group of one)
    qs, ss = qops.quantize_group([u * 0.1 for u in us], 8)
    before = wops.dequant_agg.launches
    outs = wops.dequant_agg_group(qs, ss, w, den)
    torch.cuda.synchronize()
    if wops.dequant_agg.launches != before + 1:
        fail(f"dequant_agg_group over {len(qs)} leaves made "
             f"{wops.dequant_agg.launches - before} launches, not 1")
    err = max(float((o - dequant_agg_ref(q, s, w, den)).abs().max())
              for q, s, o in zip(qs, ss, outs))
    err = max([err] + [float((wops.dequant_agg(q, s, w, den)
                              - dequant_agg_ref(q, s, w, den)).abs().max())
                       for q, s in zip(qs, ss)])
    if not err <= AGG_TOL:
        fail(f"dequant_agg N={n}: max_abs_err {err} > {AGG_TOL}")
    t = timings(lambda: wops.dequant_agg_group(qs, ss, w, den),
                lambda: [dequant_agg_ref(q, s, w, den)
                         for q, s in zip(qs, ss)])
    pads = [q.shape[1] for q in qs]
    leaf_bytes = [n * p + n * p // 32 + (n + 1) * 4 + p * 4 for p in pads]
    # per value: convert, scale, multiply-add
    b_ms, b_by = bound(sum(leaf_bytes), sum(4 * n * p for p in pads))
    diag = leaf_diagnostics(
        pads, leaf_bytes,
        lambda idx: wops.dequant_agg_group([qs[i] for i in idx],
                                           [ss[i] for i in idx], w, den))
    diag["back_to_back_ms"] = graph_ms(lambda: [
        wops.dequant_agg_group(qs, ss, w, den)
        for _ in range(BACK_TO_BACK)]) / BACK_TO_BACK
    rows[("dequant_agg", n)] = dict(max_abs_err=err, bound_ms=b_ms,
                                    bound_by=b_by, diag=diag, **t)

    # ragged and unaligned shapes: the masked edge and the scalar paths
    for rn, d in RAGGED_SINGLE:
        wr = torch.rand(rn, generator=gen, device=device)
        dr = torch.clamp(wr.sum(), min=1e-12)
        for u in (torch.randn(rn, d, generator=gen, device=device),
                  unaligned((rn, d), gen, device)):
            e = float((wops.weighted_agg(u, wr, dr)
                       - weighted_agg_ref(u, wr, dr)).abs().max())
            if not e <= AGG_TOL:
                fail(f"weighted_agg ragged {(rn, d)}: {e}")
    for rn, d, block in RAGGED_DEQ:
        wr = torch.rand(rn, generator=gen, device=device)
        dr = torch.clamp(wr.sum(), min=1e-12)
        q = torch.randint(-127, 128, (rn, d + 1), generator=gen,
                          device=device, dtype=torch.int8)
        s = torch.rand(rn, d // block, generator=gen, device=device) * 0.05
        for qq in (q[:, :d].contiguous(), q.reshape(-1)[1:rn * d + 1]
                   .view(rn, d)):
            e = float((wops.dequant_agg(qq, s, wr, dr, block)
                       - dequant_agg_ref(qq, s, wr, dr, block)).abs().max())
            if not e <= AGG_TOL:
                fail(f"dequant_agg ragged {(rn, d, block)}: {e}")
    # aligned, unaligned and ragged leaves (a last tile part full) in one
    # grouped call
    for block in (64, 128):
        wr = torch.rand(5, generator=gen, device=device)
        wr[1] = 0.0
        dr = torch.clamp(wr.sum(), min=1e-12)
        qs, ss = [], []
        for i, nb in enumerate(MIXED_DEQ_BLOCKS):
            q = torch.randint(-127, 128, (5 * nb * block + 1,),
                              generator=gen, device=device, dtype=torch.int8)
            qs.append(q[i % 2:5 * nb * block + i % 2].view(5, nb * block))
            ss.append(torch.rand(5, nb, generator=gen, device=device) * 0.05)
        for q, s, o in zip(qs, ss, wops.dequant_agg_group(qs, ss, wr, dr,
                                                          block)):
            e = float((o - dequant_agg_ref(q, s, wr, dr, block)).abs().max())
            if not e <= AGG_TOL:
                fail(f"dequant_agg mixed group block={block} "
                     f"D={q.shape[1]}: {e}")
    torch.cuda.synchronize()
    return rows


# the CNN's eight 3x3 convolutions (Cin, Cout, H) at the pair step's
# shapes (phase 3b): 64 pairs of 32 images
CONV_LAYERS = ((3, 32, 32), (32, 32, 32), (32, 64, 16), (64, 64, 16),
               (64, 128, 8), (128, 128, 8), (128, 256, 4), (256, 256, 4))
CONV_G, CONV_N = 64, 32
# the other calls the main path makes, held to float64 but not timed:
# (G, N, backward) of FedAvg's 16-pair step (other wgrad slice counts)
# and the eval's fold (30 devices' 128 images, one model: forward only)
CONV_CHECKS = ((16, 32, True), (1, 30 * 128, False))
CONV_TOL = 3e-5     # of the product summed in absolute values (float64)


def conv_error(out, exact, scale):
    """Worst error of ``out`` against the float64 ``exact``, as a share of
    the same product summed in absolute values (``scale``)."""
    return float(((out.double() - exact).abs() / (scale + 1e-30)).max())


def conv_case(gen, G, N, cin, cout, h, device, tag, backward=True):
    """Random operands of one layer (post-ReLU x, He-scaled w, G groups of
    N images) and the kernels' worst errors against float64, each held to
    CONV_TOL: forward (bias and ReLU) and, with ``backward``, dgrad and
    wgrad (with the bias gradient). Returns ((x, w, b, dy, y), errors by
    kind)."""
    import torch

    from repro_torch.kernels.conv3x3 import ops as cops
    from repro_torch.kernels.conv3x3 import ref as cref

    x = torch.randn(G, N, h, h, cin, generator=gen, device=device).relu()
    w = torch.randn(G, 3, 3, cin, cout, generator=gen, device=device) \
        * (2.0 / (9 * cin)) ** 0.5
    b = 0.05 * torch.randn(G, cout, generator=gen, device=device)
    dy = torch.randn(G, N, h, h, cout, generator=gen, device=device)
    y = cops.conv3x3_fwd(x, w, b)
    x64, w64, b64, y64 = (t.double() for t in (x, w, b, y))
    errs = {"fwd": conv_error(
        y, cref.conv3x3_fwd_ref(x64, w64, b64),
        cref.conv3x3_fwd_ref(x64.abs(), w64.abs(), b64.abs()))}
    if backward:
        dy64 = dy.double()
        dx = cops.conv3x3_dgrad(dy, y, w)
        dw, db = cops.conv3x3_wgrad(x, dy, y)
        exact_w = cref.conv3x3_wgrad_ref(x64, dy64, y64)
        scale_w = cref.conv3x3_wgrad_ref(x64.abs(), dy64.abs(), y64)
        errs["dgrad"] = conv_error(
            dx, cref.conv3x3_dgrad_ref(dy64, y64, w64),
            cref.conv3x3_dgrad_ref(dy64.abs(), y64, w64.abs()))
        errs["wgrad"] = max(conv_error(dw, exact_w[0], scale_w[0]),
                            conv_error(db, exact_w[1], scale_w[1]))
    for kind, err in errs.items():
        if not err <= CONV_TOL:
            fail(f"{tag} {kind}: error {err} of the absolute scale > "
                 f"{CONV_TOL}")
    return (x, w, b, dy, y), errs


def check_conv(device):
    """Phase 3b: the convolution kernels (``kernels/conv3x3``) against
    their plain versions at each layer: at the pair step's shapes (G=64
    pairs of N=32 images) forward (bias and ReLU), dgrad and wgrad (with
    the bias gradient), each held to float64 and timed beside its bound
    (FLOPs at the float32 peak, or bytes), the plain version (the CNN's
    former F.conv2d formulation: permutes and cuDNN's grouped
    convolution) and cuDNN's own call on operands already in its layout
    (``library_ms``: the grouped F.conv2d, or its convolution_backward
    for one gradient, given the masked dy; the port never calls it);
    then the CONV_CHECKS shapes, held to float64 alone. Returns the timed
    rows and the checks' errors."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.conv3x3 import ops as cops
    from repro_torch.kernels.conv3x3 import ref as cref

    gen = torch.Generator(device=device).manual_seed(0)
    G, N = CONV_G, CONV_N
    conv = dict(stride=[1, 1], padding=[1, 1], dilation=[1, 1],
                transposed=False, output_padding=[0, 0], groups=G)
    rows, checks = [], []
    for layer, (cin, cout, h) in enumerate(CONV_LAYERS):
        for g_, n_, backward in CONV_CHECKS:
            _, errs = conv_case(gen, g_, n_, cin, cout, h, device,
                                f"conv layer {layer} G={g_} N={n_}",
                                backward)
            checks.append(dict(layer=layer, G=g_, N=n_, **errs))
        (x, w, b, dy, y), errs = conv_case(gen, G, N, cin, cout, h, device,
                                           f"conv layer {layer}")
        # cuDNN's operands in its own layout, made once, outside the timing
        xc = cref._nchw(x)
        gc = cref._nchw(torch.where(y > 0, dy, 0))
        wc = cref._oihw(w)
        dummy_x = torch.empty_like(xc)
        pixels = N * h * h
        flops = 2 * pixels * cout * 9 * cin * G
        act_in, act_out = pixels * cin * G * 4, pixels * cout * G * 4
        wbytes = (9 * cin * cout + cout) * G * 4
        calls = {
            "fwd": (lambda: cops.conv3x3_fwd(x, w, b),
                    lambda: cref.conv3x3_fwd_ref(x, w, b),
                    lambda: F.conv2d(xc, wc, b.reshape(-1), padding=1,
                                     groups=G),
                    flops, act_in + wbytes + act_out),
            "dgrad": (lambda: cops.conv3x3_dgrad(dy, y, w),
                      lambda: cref.conv3x3_dgrad_ref(dy, y, w),
                      lambda: torch.ops.aten.convolution_backward(
                          gc, dummy_x, wc, None,
                          output_mask=[True, False, False], **conv),
                      flops, 2 * act_out + wbytes + act_in),
            "wgrad": (lambda: cops.conv3x3_wgrad(x, dy, y),
                      lambda: cref.conv3x3_wgrad_ref(x, dy, y),
                      lambda: torch.ops.aten.convolution_backward(
                          gc, xc, wc, [G * cout],
                          output_mask=[False, True, True], **conv),
                      flops + pixels * cout * G,
                      act_in + 2 * act_out + wbytes),
        }
        for kind, (kernel, plain, library, nflops, nbytes) in calls.items():
            b_ms, b_by = bound(nbytes, nflops)
            t = timings(kernel, plain, library)
            rows.append(dict(layer=layer, kind=kind, cin=cin, cout=cout,
                             h=h, err=errs[kind], bound_ms=b_ms,
                             bound_by=b_by, roofline=b_ms / t["ms"], **t))
        del x, w, b, dy, y, xc, gc, wc, dummy_x
    torch.cuda.empty_cache()
    return rows, checks


def print_conv(rows, checks):
    for r in rows:
        print(f"[conv L{r['layer']} {r['kind']} G={CONV_G} N={CONV_N} "
              f"Cin={r['cin']} Cout={r['cout']} H=W={r['h']}] "
              f"err={r['err']:.3g} ms={r['ms']:.5f} "
              f"eager_ms={r['eager_ms']:.5f} plain_ms={r['plain_ms']:.5f} "
              f"library_ms={r['library_ms']:.5f} bound_ms="
              f"{r['bound_ms']:.5f} ({r['bound_by']}) "
              f"of_bound={100 * r['roofline']:.1f}%", flush=True)
    for kind in ("fwd", "dgrad", "wgrad"):
        sel = [r for r in rows if r["kind"] == kind]
        print(f"[conv {kind} total] ms={sum(r['ms'] for r in sel):.4f} "
              f"plain_ms={sum(r['plain_ms'] for r in sel):.4f} "
              f"library_ms={sum(r['library_ms'] for r in sel):.4f} "
              f"bound_ms={sum(r['bound_ms'] for r in sel):.4f}", flush=True)
    for c in checks:
        errs = " ".join(f"{k}_err={c[k]:.3g}" for k in ("fwd", "dgrad",
                                                        "wgrad") if k in c)
        print(f"[conv check L{c['layer']} G={c['G']} N={c['N']}] {errs}",
              flush=True)


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


def engines_agree(device):
    """Phase 6: the legacy, batched and fused engines on the card, FedCD
    over 8 MLP rounds and FedAvg over 4 (the reference's engine-
    equivalence setup: 8 devices, milestones 2/5), unquantized: discrete
    state exact, params within AGG_TOL. Then the pipelined and sparse
    fused runs (``PIPELINE_SPECS``, ``fused+pipeline`` for FedAvg), each
    held to the ``fused`` run at the same bar. Returns the largest param
    difference, the live models and each pipelined run's
    ``pipeline_stats``."""
    import torch

    from repro_torch.configs.fedcd_cifar import HIERARCHICAL
    from repro_torch.core.fedavg import FedAvgServer
    from repro_torch.core.fedcd import ENGINES, FedCDServer
    from repro_torch.data.partition import hierarchical_devices, stack_devices
    from repro_torch.models.mlp import (init_mlp_classifier, mlp_accuracy,
                                        mlp_loss)

    data = stack_devices(hierarchical_devices(
        seed=0, devices_per_archetype=1, n_train=64, n_val=32, n_test=32,
        noise=2.0)[:8])
    cfg = dataclasses.replace(HIERARCHICAL, n_devices=8, devices_per_round=4,
                              milestones=(2, 5), max_models=8,
                              late_delete_round=6, seed=0)
    params = init_mlp_classifier(torch.Generator().manual_seed(0),
                                 hidden=32)

    fedcd, fedavg = {}, {}
    for engine in ENGINES + PIPELINE_SPECS:
        fedcd[engine] = FedCDServer(cfg, params, mlp_loss, mlp_accuracy,
                                    data, batch_size=16, spec=engine,
                                    device=device)
        fedcd[engine].run(ENGINE_ROUNDS)
    for engine in ENGINES + ("fused+pipeline",):
        fedavg[engine] = FedAvgServer(cfg, params, mlp_loss, mlp_accuracy,
                                      data, batch_size=16, spec=engine,
                                      device=device)
        fedavg[engine].run(4)
    err = 0.0
    pairs = ([("legacy", e) for e in ("batched", "fused")]
             + [("fused", e) for e in PIPELINE_SPECS])
    for base, engine in pairs:
        err = max(err, trajectory_err(fedcd[base], fedcd[engine],
                                      f"engines: FedCD {engine} against "
                                      f"{base}"))
    for base, engine in [("legacy", "batched"), ("legacy", "fused"),
                         ("fused", "fused+pipeline")]:
        err = max(err, trajectory_err(fedavg[base], fedavg[engine],
                                      f"engines: FedAvg {engine} against "
                                      f"{base}"))
    if not err <= AGG_TOL:
        fail(f"engines: params differ by {err} > {AGG_TOL}")
    stats = {f"fedcd {s}": fedcd[s].pipeline_stats.as_dict()
             for s in PIPELINE_SPECS if fedcd[s].pipeline_stats}
    stats["fedavg fused+pipeline"] = \
        fedavg["fused+pipeline"].pipeline_stats.as_dict()
    sparse = {s: fedcd[s].planner.sparse_rounds for s in PIPELINE_SPECS}
    return err, fedcd["legacy"].registry.live_ids(), stats, sparse


def engine_path(device, engine):
    """Phase 7: FedCD and FedAvg on ``engine`` ("legacy" or "batched")
    with phase 5's configuration: the paper's CNN at full width, 30
    devices, int8 transport, 6 rounds (round 6 aggregates two models).
    Returns the per-round walls."""
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
                        batch_size=32, spec=engine, device=device)
    fedavg = FedAvgServer(cfg, params, cnn_loss, cnn_accuracy, data,
                          batch_size=32, spec=engine, device=device)
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
        print(f"[{engine} round {t}] fedcd wall_s={t1 - t0:.4f} "
              f"test_acc={m.test_acc.mean():.4f} live={m.live_models} "
              f"active={m.active_models} | fedavg wall_s={t2 - t1:.4f} "
              f"test_acc={a.test_acc.mean():.4f}", flush=True)
        if not (np.isfinite(m.test_acc).all() and np.isfinite(a.test_acc).all()):
            fail(f"{engine} round {t}: non-finite accuracy")
    if fedcd.metrics[4].live_models < 2:
        fail(f"{engine}: fewer than 2 live models after round 5")
    trees = [(f"fedcd model {m}", fedcd.registry.params[m])
             for m in fedcd.registry.live_ids()] + [("fedavg", fedavg.params)]
    for name, tree in trees:
        if not all(bool(torch.isfinite(v).all()) for v in tree.values()):
            fail(f"{engine} {name}: non-finite params after "
                 f"{SMOKE_ROUNDS} rounds")
    return walls


class OverlapProbe:
    """The overlap check, wired in by wrapping the pipelined executors'
    ``speculate`` and ``readback``: a CUDA event is recorded right after
    each speculative training is enqueued and queried right after the
    next ``readback()`` returns. ``overlapped`` counts the readbacks that
    returned while that training was still running; ``speculated`` the
    readbacks that had one in flight; ``last`` is the latest readback's
    finding (None when it had no speculation in flight).

    ``hold_cycles``: a device spin (``torch.cuda._sleep``) enqueued right
    after each speculation, before the event. Where the host enqueues
    the training more slowly than the card runs it, the training ends
    about when its enqueue does, whatever the readback waits on; the
    spin keeps the stream busy for a fixed time after it, so a readback
    that waits on its own copies returns inside the spin and one that
    waits on the stream returns after it, on any host."""

    def __init__(self, classes, hold_cycles: int = 0):
        import torch
        self.speculated = self.overlapped = 0
        self.last = None
        self._saved = [(cls, cls.speculate, cls.readback) for cls in classes]
        for cls, speculate, readback in self._saved:
            def spec(ex, plan, _inner=speculate):
                before = ex._spec
                _inner(ex, plan)
                ex._probe_event = None
                if ex._spec is not None and ex._spec is not before:
                    if hold_cycles:
                        torch.cuda._sleep(hold_cycles)
                    ex._probe_event = torch.cuda.Event()
                    ex._probe_event.record()

            def read(ex, _inner=readback):
                out = _inner(ex)
                event = getattr(ex, "_probe_event", None)
                self.last = None
                if event is not None:
                    self.last = not event.query()
                    self.speculated += 1
                    self.overlapped += int(self.last)
                    ex._probe_event = None
                return out
            cls.speculate, cls.readback = spec, read

    def remove(self) -> None:
        for cls, speculate, readback in self._saved:
            cls.speculate, cls.readback = speculate, readback


def cnn_cell():
    """Phase 5's configuration: the paper's CNN at full width, 30 devices
    at the partition's default sizes, int8 transport, lr CNN_LR. Returns
    (cfg, params, data, loss_fn, acc_fn)."""
    import torch

    from repro_torch.configs.fedcd_cifar import HIERARCHICAL
    from repro_torch.data.partition import hierarchical_devices, stack_devices
    from repro_torch.models.cnn import cnn_accuracy, cnn_loss, init_cnn

    data = stack_devices(hierarchical_devices(seed=0))
    cfg = dataclasses.replace(HIERARCHICAL, quantize_bits=8, lr=CNN_LR)
    params = init_cnn(torch.Generator().manual_seed(0))
    return cfg, params, data, cnn_loss, cnn_accuracy


def overlap_check(device):
    """Phase 9: FedCD and FedAvg on ``fused+pipeline`` for OVERLAP_ROUNDS
    rounds of the CNN cell, to be run under an :class:`OverlapProbe` with
    ``hold_cycles``. Returns the speculations consumed (hit + repaired)."""
    import torch

    from repro_torch.core.fedavg import FedAvgServer
    from repro_torch.core.fedcd import FedCDServer

    cfg, params, data, loss_fn, acc_fn = cnn_cell()
    consumed = 0
    for cls in (FedCDServer, FedAvgServer):
        srv = cls(cfg, params, loss_fn, acc_fn, data, batch_size=32,
                  spec="fused+pipeline", device=device)
        srv.run(OVERLAP_ROUNDS)
        torch.cuda.synchronize()
        st = srv.pipeline_stats
        consumed += st.hit + st.repaired
    return consumed


PIPELINED_PATHS = (("fedcd fused+pipeline", "fedcd", "fused+pipeline"),
                   ("fedavg fused+pipeline", "fedavg", "fused+pipeline"),
                   ("fedcd fused+pipeline+sparse:1.1", "fedcd",
                    "fused+pipeline+sparse:1.1"))


def pipelined_path(device, probe, name, server, spec):
    """Phase 8, one path: phase 5's configuration (the paper's CNN at full
    width, 30 devices, int8 transport, 6 rounds) on ``spec`` for the
    ``server`` ("fedcd" or "fedavg"). Rounds run back to back with no
    synchronisation between them (a pipelined round returns with the next
    round's training on the card), so a round's wall is the host time
    from one ``run_round`` return to the next; the card is drained at the
    end. Each round's line says whether its readback overlapped the
    speculation (``probe``, an installed :class:`OverlapProbe`). Returns
    (walls, drain_s, pipeline_stats)."""
    import torch

    from repro_torch.core.fedavg import FedAvgServer
    from repro_torch.core.fedcd import FedCDServer

    cfg, params, data, cnn_loss, cnn_accuracy = cnn_cell()
    cls = FedCDServer if server == "fedcd" else FedAvgServer
    srv = cls(cfg, params, cnn_loss, cnn_accuracy, data, batch_size=32,
              spec=spec, device=device)
    walls = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(1, SMOKE_ROUNDS + 1):
        m = srv.run_round(t)
        t1 = time.perf_counter()
        walls.append(t1 - t0)
        t0 = t1
        live = (f" live={m.live_models} active={m.active_models}"
                if cls is FedCDServer else "")
        print(f"[{name} round {t}] wall_s={walls[-1]:.4f} "
              f"test_acc={m.test_acc.mean():.4f}{live} "
              f"readback_overlapped={probe.last}", flush=True)
        if not (np.isfinite(m.test_acc).all()
                and np.isfinite(m.val_acc).all()):
            fail(f"{name} round {t}: non-finite accuracy")
    torch.cuda.synchronize()
    drain = time.perf_counter() - t0
    if cls is FedCDServer:
        if srv.metrics[4].live_models < 2:
            fail(f"{name}: fewer than 2 live models after round 5")
        trees = [srv.registry.params[m] for m in srv.registry.live_ids()]
    else:
        trees = [srv.params]
    if not all(bool(torch.isfinite(v).all()) for tree in trees
               for v in tree.values()):
        fail(f"{name}: non-finite params after {SMOKE_ROUNDS} rounds")
    return walls, drain, srv.pipeline_stats.as_dict()


def count_roundtrips():
    """Wrap ``core.quantize.roundtrip_rows`` (which ``roundtrip`` calls
    too) so that it counts its calls and the launches of each transport
    kernel they must make: one per ``max_leaves`` non-empty leaves of a
    call. Returns the wrapper, whose ``calls`` and ``launches`` the caller
    resets."""
    from repro_torch.core import quantize as qz
    from repro_torch.kernels.quantize import ops as qops
    inner = qz.roundtrip_rows
    cap = qops.max_leaves()

    def counted(stacked, bits=8):
        if bits > 0:
            live = sum(1 for v in stacked.values() if v.numel())
            counted.calls += 1
            counted.launches += -(-live // cap)
        return inner(stacked, bits)
    counted.calls = counted.launches = 0
    qz.roundtrip_rows = counted
    return counted


class NoSyncProbe:
    """Phases 10-11: the straggler harvest, the stale fold and the data
    bank's row writes run under ``torch.cuda.set_sync_debug_mode("error")``,
    so a call in them that waits for the stream (a pageable copy,
    ``.cpu()``, ``.item()``) raises and fails the run. ``calls`` counts
    the watched calls that had work: harvests, folds of a plan with
    folds, row writes."""

    def __init__(self):
        from repro_torch.data.bank import DeviceDataBank
        from repro_torch.federated import executors as ex
        self.calls = {"harvest": 0, "fold": 0, "row_write": 0}
        self._saved = []
        self._watch(ex, "_harvest_rows", "harvest", lambda a: True)
        for cls in (ex.FusedExecutor, ex.FedAvgFusedExecutor):
            self._watch(cls, "_fold_stale", "fold", lambda a: bool(a[1].folds))
        self._watch(DeviceDataBank, "_write_row", "row_write", lambda a: True)

    def _watch(self, owner, attr, key, has_work):
        import torch
        inner = getattr(owner, attr)

        def watched(*args):
            self.calls[key] += int(has_work(args))
            torch.cuda.set_sync_debug_mode("error")
            try:
                return inner(*args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        setattr(owner, attr, watched)
        self._saved.append((owner, attr, inner))

    def remove(self) -> None:
        for owner, attr, inner in self._saved:
            setattr(owner, attr, inner)


def run_cell(device, name, server, spec, rounds=SMOKE_ROUNDS, watch=None):
    """Phases 10-11, one path: phase 5's configuration (the paper's CNN
    at full width, 30 devices, int8 transport) on ``spec`` (a preset or
    an EngineSpec) for the ``server`` ("fedcd" or "fedavg"), ``rounds``
    rounds. ``watch(srv)`` may instrument the server first. A server
    resumed from a checkpoint at construction runs from the round after
    it. A synchronous round is timed to its end
    (``torch.cuda.synchronize()``); pipelined rounds run back to back,
    each timed from one ``run_round`` return to the next, and the card's
    drain after the last is timed on its own (a speculation of the round
    after the last). Prints one line a round. Returns (server, walls of
    the rounds run, drain_s)."""
    import torch

    from repro_torch.core.fedavg import FedAvgServer
    from repro_torch.core.fedcd import FedCDServer

    cfg, params, data, loss_fn, acc_fn = cnn_cell()
    cls = FedCDServer if server == "fedcd" else FedAvgServer
    srv = cls(cfg, params, loss_fn, acc_fn, data, batch_size=32, spec=spec,
              device=device)
    if watch is not None:
        watch(srv)
    walls = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(len(srv.metrics) + 1, rounds + 1):
        m = srv.run_round(t)
        if not srv.pipeline:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        walls.append(t1 - t0)
        t0 = t1
        extra = ""
        if cls is FedCDServer:
            extra += (f" live={m.live_models} active={m.active_models} "
                      f"present={int(srv.present.sum())}")
        if srv.semisync_stats is not None:
            st = srv.semisync_stats
            extra += (f" stragglers={st.stragglers} dropouts={st.dropouts} "
                      f"folded={st.folded} expired={st.expired}")
        print(f"[{name} round {t}] wall_s={walls[-1]:.4f} "
              f"test_acc={m.test_acc.mean():.4f}{extra}", flush=True)
        if not (np.isfinite(m.test_acc).all()
                and np.isfinite(m.val_acc).all()):
            fail(f"{name} round {t}: non-finite accuracy")
    torch.cuda.synchronize()
    drain = time.perf_counter() - t0
    trees = ([srv.registry.params[m] for m in srv.registry.live_ids()]
             if cls is FedCDServer else [srv.params])
    if not all(bool(torch.isfinite(v).all()) for tree in trees
               for v in tree.values()):
        fail(f"{name}: non-finite params after {rounds} rounds")
    return srv, walls, drain


def trajectory_err(ref, other, tag):
    """Fail unless two runs of one server class walked the same
    trajectory: FedCD's live models, genealogy, active matrix, score
    history, presence and per-round metrics; FedAvg's per-round
    accuracies. Returns the largest param difference."""
    def rows(tree):
        return {k: v.detach().cpu() for k, v in tree.items()}

    for a, b in zip(ref.metrics, other.metrics, strict=True):
        if not (np.array_equal(a.test_acc, b.test_acc)
                and np.array_equal(a.val_acc, b.val_acc)
                and a.comm_bytes == b.comm_bytes):
            fail(f"{tag}: round {a.round} metrics differ")
    if not hasattr(ref, "registry"):
        pairs = [(rows(ref.params), rows(other.params))]
    else:
        if (ref.registry.live_ids() != other.registry.live_ids()
                or ref.registry.genealogy() != other.registry.genealogy()
                or not np.array_equal(ref.state.active, other.state.active)
                or not np.array_equal(ref.state.history, other.state.history,
                                      equal_nan=True)
                or not np.array_equal(ref.present, other.present)
                or not all(np.array_equal(a.preferred, b.preferred)
                           and a.live_models == b.live_models
                           and a.active_models == b.active_models
                           for a, b in zip(ref.metrics, other.metrics))):
            fail(f"{tag}: control-plane state differs")
        pairs = [(rows(ref.registry.params[m]), rows(other.registry.params[m]))
                 for m in ref.registry.live_ids()]
    return max([0.0] + [float((a[k] - b[k]).abs().max())
                        for a, b in pairs for k in a])


def eval_only_watch(seen):
    """A ``run_cell`` watch: record, per launched plan, whether it had
    work pairs but no aggregated model (the FedCD no-aggregate branch),
    and count FedAvg's ``_dispatch_eval_only`` calls."""
    def watch(srv):
        ex = srv.executor
        if hasattr(ex, "_dispatch_eval_only"):
            inner_eval = ex._dispatch_eval_only

            def eval_only():
                seen["eval_only"] += 1
                return inner_eval()
            ex._dispatch_eval_only = eval_only
        inner = ex.launch

        def launch(plan):
            if plan.pair_model and not plan.agg_models:
                seen["no_aggregate"].append(plan.round)
            inner(plan)
        ex.launch = launch
    return watch


def churn_schedule(data):
    """Phase 11's schedule, its split sizes those of ``data``."""
    from repro_torch.data.scenarios import random_churn
    n = {k: data[k][0].shape[1] for k in ("train", "val", "test")}
    return random_churn(SMOKE_ROUNDS, data["train"][0].shape[0],
                        seed=CHURN_SEED, n_train=n["train"],
                        n_val=n["val"], n_test=n["test"], **CHURN_RATES)


def semisync_phase(run_path, nosync):
    """Phase 10: semi-synchronous rounds at full width. ``run_path(name,
    server, spec, rounds=, watch=)`` runs one path with its own launch
    counts (``run_cell``) and returns (server, walls); ``nosync`` is the
    installed :class:`NoSyncProbe`."""
    from repro_torch.core.spec import EngineSpec
    from repro_torch.data.scenarios import DeviceDropout, StragglerModel

    # the zero-latency gate: fused+semisync with StragglerModel.zero()
    # is fused, bit for bit
    zero = EngineSpec(straggler=StragglerModel.zero())
    gate = {}
    for server in ("fedcd", "fedavg"):
        ref, w_ref = run_path(f"{server} fused", server, "fused")
        srv, _ = run_path(f"{server} fused+semisync zero", server, zero)
        err = trajectory_err(ref, srv, f"{server} zero-latency gate")
        gate[server] = sum(w_ref)
        print(f"[semisync zero-latency {server}] discrete state equal, "
              f"params max_abs_err={err} stats="
              f"{srv.semisync_stats.as_dict()}")
        if err != 0.0:
            fail(f"{server}: zero-latency semi-sync is not bit-identical "
                 f"to fused (params max err {err})")
    # the default straggler model, synchronous and pipelined; a pipelined
    # round 1 also trains round 2, so the paths compare by total wall
    for server in ("fedcd", "fedavg"):
        runs, totals = {}, {"fused": gate[server]}
        for spec in SEMISYNC_SPECS:
            runs[spec], walls = run_path(f"{server} {spec}", server, spec)
            totals[spec] = sum(walls)
        sync, piped = (runs[s] for s in SEMISYNC_SPECS)
        st = sync.semisync_stats.as_dict()
        err = trajectory_err(sync, piped, f"{server} semisync pipelined")
        print(f"[semisync {server}] {' == '.join(SEMISYNC_SPECS)}: "
              f"discrete state equal, params max_abs_err={err}, "
              f"semisync_stats={st} pipeline_stats="
              f"{piped.pipeline_stats.as_dict()} total wall_s of "
              f"{SMOKE_ROUNDS} rounds: " + " ".join(
                  f"{k}={v:.4f}" for k, v in totals.items()))
        if piped.semisync_stats.as_dict() != st:
            fail(f"{server}: semisync stats differ when pipelined")
        if not (st["stragglers"] > 0 and st["folded"] > 0):
            fail(f"{server}: no straggler was buffered and folded "
                 f"({st})")
        if not err <= AGG_TOL:
            fail(f"{server}: semisync pipelined params differ by {err}")
    # every device's update of DROP_ROUND lost: nothing aggregates
    lost = StragglerModel(dropouts=tuple(
        DeviceDropout(DROP_ROUND, d) for d in range(N_DEVICES)))
    for server in ("fedcd", "fedavg"):
        seen = {"no_aggregate": [], "eval_only": 0}
        srv, _ = run_path(f"{server} fused+pipeline+semisync total dropout",
                          server, EngineSpec(pipeline=True, straggler=lost),
                          rounds=DROP_ROUNDS, watch=eval_only_watch(seen))
        print(f"[semisync total dropout {server}] round {DROP_ROUND}: "
              f"no-aggregate rounds={seen['no_aggregate']} "
              f"eval-only dispatches={seen['eval_only']} stats="
              f"{srv.semisync_stats.as_dict()}")
        if seen["no_aggregate"] != [DROP_ROUND]:
            fail(f"{server}: round {DROP_ROUND} did not take the "
                 f"no-aggregate branch")
        if server == "fedavg" and seen["eval_only"] != 1:
            fail("fedavg: _dispatch_eval_only did not run once")
    print(f"[nosync semisync] harvests={nosync.calls['harvest']} "
          f"folds={nosync.calls['fold']} under sync_debug_mode=error")
    if not (nosync.calls["harvest"] and nosync.calls["fold"]):
        fail("phase 10: no harvest or no fold ran under the probe")


def churn_phase(run_path, nosync):
    """Phase 11: device churn (``random_churn`` over the 30 devices) at
    full width on ``CHURN_SPECS``, each held to the first; arguments as
    :func:`semisync_phase`'s."""
    import dataclasses as dc

    from repro_torch.core.spec import EngineSpec

    data = cnn_cell()[2]
    sched = churn_schedule(data)
    t0 = time.perf_counter()
    sched.make_device(np.random.default_rng(0), 0)
    print(f"[churn] host s to draw one device's splits "
          f"({data['train'][0].shape[1]}/{data['val'][0].shape[1]}/"
          f"{data['test'][0].shape[1]} images): "
          f"{time.perf_counter() - t0:.4f}")
    kinds = [type(e).__name__ for e in sched.events]
    print(f"[churn schedule] seed={CHURN_SEED} {CHURN_RATES} events="
          f"{[(type(e).__name__, *dc.astuple(e)) for e in sched.events]}")
    if not all(k in kinds for k in ("DeviceJoin", "DeviceLeave",
                                    "LabelDrift")):
        fail(f"churn: the schedule lacks a join, leave or drift: {kinds}")
    churned, totals = {}, {}
    for spec in CHURN_SPECS:
        churned[spec], walls = run_path(
            f"fedcd {spec} churn", "fedcd",
            dc.replace(EngineSpec.parse(spec), scenario=sched))
        totals[spec] = sum(walls)
        reeval = [t for t in range(1, SMOKE_ROUNDS + 1)
                  if sched.joins_at(t) or sched.drifts_at(t)]
        print(f"[fedcd {spec} churn] rounds that re-evaluate every "
              f"live model (a join or drift clears the caches): {reeval} "
              f"walls there={[round(walls[t - 1], 4) for t in reeval]}")
    base = churned[CHURN_SPECS[0]]
    bank = base.executor.databank
    if bank.identity_map():
        fail("churn: no data row was reused (the id -> row map is the "
             "identity)")
    for spec in CHURN_SPECS[1:]:
        err = trajectory_err(base, churned[spec], f"churn {spec}")
        print(f"[churn {spec}] == {CHURN_SPECS[0]}: discrete state "
              f"equal, params max_abs_err={err}, total wall_s "
              f"{totals[spec]:.4f} against {totals[CHURN_SPECS[0]]:.4f}")
        if not err <= AGG_TOL:
            fail(f"churn {spec}: params differ by {err}")
    print(f"[churn] present={int(base.present.sum())} of "
          f"{base.n_devices} ids, rows {bank.n_cap}, row_of={bank.row_of}"
          f" sparse_rounds={churned[CHURN_SPECS[2]].planner.sparse_rounds}"
          f" pipeline_stats="
          f"{churned[CHURN_SPECS[1]].pipeline_stats.as_dict()}")
    print(f"[nosync churn] row writes={nosync.calls['row_write']} under "
          f"sync_debug_mode=error")
    if not nosync.calls["row_write"]:
        fail("phase 11: no data-bank row write ran under the probe")


class CheckpointClock:
    """Phase 12: times every snapshot and every restore the servers make.
    A snapshot is timed after the card has drained (the drain — work in
    flight, e.g. a speculation the quiesce dropped — is timed on its
    own); a restore to its end on the card (its row writes are
    non-blocking)."""

    def __init__(self):
        import torch

        from repro_torch.checkpoint import state
        from repro_torch.core import fedavg, fedcd
        self.saves, self.restores = [], []
        self._saved = []

        def timed(owner, attr, out, drain):
            inner = getattr(owner, attr)

            def call(*args, **kw):
                t0 = time.perf_counter()
                if drain:
                    torch.cuda.synchronize()
                t1 = time.perf_counter()
                result = inner(*args, **kw)
                torch.cuda.synchronize()
                out.append((t1 - t0, time.perf_counter() - t1))
                return result
            setattr(owner, attr, call)
            self._saved.append((owner, attr, inner))

        # the manager calls state's; the servers' save()/restore() and
        # resume_from call their modules' own names
        for owner in (state, fedcd, fedavg):
            timed(owner, "save_server_state", self.saves, True)
        for owner in (fedcd, fedavg):
            timed(owner, "restore_server_state", self.restores, False)

    def take(self):
        """(saves, restores) recorded since the last call, as lists of
        (drain_s, s) and (0, s)."""
        out = (list(self.saves), list(self.restores))
        self.saves.clear()
        self.restores.clear()
        return out

    def remove(self) -> None:
        for owner, attr, inner in self._saved:
            setattr(owner, attr, inner)


def resume_phase(run_path, crash_path, clock, device):
    """Phase 12: crash and resume at full width (phase 5's CNN cell, one
    checkpoint every CKPT_EVERY rounds into a temporary directory). For
    each path of RESUME_PATHS: one uninterrupted run, then per scripted
    fault a run that crashes there and a FRESH server resumed from the
    checkpoint root (no faults) run to round SMOKE_ROUNDS; each resumed
    run must equal the uninterrupted one (discrete state, metrics,
    ``comm_bytes``, params max err 0.0; ``semisync_stats`` too; under
    churn the present ids and ``next_id``). ``run_path`` and
    ``crash_path(name, server, spec)`` run one counted path (the latter
    expects the crash and fails without it); ``clock`` is the installed
    :class:`CheckpointClock`. Last, the uninterrupted FedCD run's final
    state, saved on the card, restores into a CPU server. Returns the
    per-path numbers it printed."""
    import dataclasses as dc
    import tempfile

    from repro_torch.checkpoint import latest_checkpoint, verify_checkpoint
    from repro_torch.checkpoint.state import ARRAYS, MANIFEST
    from repro_torch.core.fedcd import FedCDServer
    from repro_torch.core.spec import EngineSpec
    from repro_torch.data.scenarios import FaultEvent, FaultSchedule

    cfg, params, data, loss_fn, acc_fn = cnn_cell()
    sched = churn_schedule(data)
    report = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        cpu_ckpt = None
        for name, server, spec_name, faults in RESUME_PATHS:
            base = (dc.replace(EngineSpec.parse("fused+pipeline"),
                               scenario=sched)
                    if spec_name == "churn" else EngineSpec.parse(spec_name))
            ref, ref_walls = run_path(f"{name} uninterrupted", server, base)
            if server == "fedcd" and cpu_ckpt is None:
                cpu_ckpt = (ref, ref.save(os.path.join(tmp, "final")),
                            clock.take()[0][0])
            for t, phase in faults:
                root = os.path.join(tmp, f"{server}-{spec_name}-{phase}")
                faulted = dc.replace(
                    base, save_every=CKPT_EVERY, checkpoint_dir=root,
                    faults=FaultSchedule((FaultEvent(t, phase),)))
                tag = f"{name} crash {phase}@{t}"
                crash_path(tag, server, faulted)
                saves, _ = clock.take()
                steps = sorted(d for d in os.listdir(root)
                               if d.startswith("step_"))
                sizes = {d: os.path.getsize(os.path.join(root, d, ARRAYS))
                         for d in steps}
                latest = latest_checkpoint(root)
                if phase == "mid-save":
                    torn = os.path.join(root, f"step_{t:06d}")
                    if not (os.path.exists(os.path.join(torn, ARRAYS))
                            and not os.path.exists(
                                os.path.join(torn, MANIFEST))
                            and latest.endswith(
                                f"step_{t - CKPT_EVERY:06d}")):
                        fail(f"{tag}: the torn step was not skipped "
                             f"(latest={latest})")
                res, walls = run_path(f"{name} resume {phase}@{t}", server,
                                      dc.replace(base, resume_from=root))
                _, restores = clock.take()
                err = trajectory_err(ref, res, f"{tag} resumed")
                first = SMOKE_ROUNDS - len(walls) + 1
                checks = []
                if ref.semisync_stats is not None:
                    same = (res.semisync_stats.as_dict()
                            == ref.semisync_stats.as_dict())
                    checks.append(f"semisync_stats equal={same}")
                    if not same:
                        fail(f"{tag}: semisync_stats differ after resume")
                if spec_name == "churn":
                    same = (res.databank.present_ids()
                            == ref.databank.present_ids()
                            and res.databank.next_id == ref.databank.next_id)
                    checks.append(f"present ids and next_id equal={same}")
                    if not same:
                        fail(f"{tag}: the population differs after resume")
                line = {
                    "resumed_from": os.path.basename(latest),
                    "arrays_npz_bytes": sizes,
                    "save_s": [round(s, 4) for _, s in saves],
                    "save_drain_s": [round(d, 4) for d, _ in saves],
                    "restore_s": [round(s, 4) for _, s in restores],
                    "resumed_round": first,
                    "resumed_round_wall_s": round(walls[0], 4),
                    "uninterrupted_round_wall_s": round(
                        ref_walls[first - 1], 4),
                    "params_max_abs_err": err}
                print(f"[resume {tag}] discrete state equal " + " ".join(
                    checks) + " " + json.dumps(line), flush=True)
                report[tag] = line
                if err != 0.0:
                    fail(f"{tag}: resumed params differ from the "
                         f"uninterrupted run by {err}")
        # card -> CPU: the final state of the uninterrupted FedCD run
        card, path, (_, save_s) = cpu_ckpt
        verify_checkpoint(path)
        host = FedCDServer(cfg, params, loss_fn, acc_fn, data, batch_size=32,
                           spec="fused", device="cpu")
        t0 = time.perf_counter()
        host.restore(path)
        took = time.perf_counter() - t0
        err = trajectory_err(card, host, "card checkpoint on the CPU")
        print(f"[resume card->cpu] verify_checkpoint passed, discrete state "
              f"equal, params max_abs_err={err}, save_s={save_s:.4f} (on "
              f"{device}, round {SMOKE_ROUNDS}) restore_s={took:.4f} (cpu) "
              f"arrays_npz_bytes={os.path.getsize(os.path.join(path, ARRAYS))}",
              flush=True)
        if err != 0.0 or any(v.device.type != "cpu" for m in
                             host.registry.live_ids()
                             for v in host.registry.params[m].values()):
            fail("card checkpoint on the CPU: params differ or not on the "
                 "CPU")
    return report


def param_gap(ref, other):
    """(largest |a - b|, largest |a - b| - SHARDED_F32_TOL * |a|) over two
    param dicts (host or card)."""
    gap = beyond = 0.0
    for k, a in ref.items():
        a = a.detach().cpu()
        d = (a - other[k].detach().cpu()).abs()
        gap = max(gap, float(d.max()))
        beyond = max(beyond, float((d - SHARDED_F32_TOL * a.abs()).max()))
    return gap, beyond


def sharded_err(ref, other, tag):
    """Fail unless a sharded run kept the fused run's discrete state:
    per round ``comm_bytes`` (both servers), FedCD's live ids, genealogy,
    active matrix, preferred models and live/active counts. Returns the
    largest param difference, the largest beyond ``SHARDED_F32_TOL``
    relative, and the largest accuracy difference."""
    acc = 0.0
    for a, b in zip(ref.metrics, other.metrics, strict=True):
        if a.comm_bytes != b.comm_bytes:
            fail(f"{tag}: round {a.round} comm_bytes {b.comm_bytes} != "
                 f"fused {a.comm_bytes}")
        acc = max(acc, float(np.abs(a.test_acc - b.test_acc).max()),
                  float(np.abs(a.val_acc - b.val_acc).max()))
    if not hasattr(ref, "registry"):
        return param_gap(ref.params, other.params) + (acc,)
    if (ref.registry.live_ids() != other.registry.live_ids()
            or ref.registry.genealogy() != other.registry.genealogy()
            or not np.array_equal(ref.state.active, other.state.active)
            or not all(np.array_equal(a.preferred, b.preferred)
                       and a.live_models == b.live_models
                       and a.active_models == b.active_models
                       for a, b in zip(ref.metrics, other.metrics))):
        fail(f"{tag}: discrete state differs from the fused run")
    gaps = [param_gap(ref.registry.params[m], other.registry.params[m])
            for m in ref.registry.live_ids()]
    return (max(g for g, _ in gaps), max(b for _, b in gaps), acc)


def round_hook(after):
    """A ``run_cell`` watch: ``after(srv, t)`` runs after each round."""
    def watch(srv):
        inner = srv.run_round

        def run_round(t):
            m = inner(t)
            after(srv, t)
            return m
        srv.run_round = run_round
    return watch


def migrate_after(moved):
    """After round MIGRATE_AFTER, move the newest live model's bank row
    to the next model shard (recorded in ``moved``)."""
    def after(srv, t):
        if t == MIGRATE_AFTER:
            bank = srv.registry.params
            mid = max(srv.registry.live_ids())
            src = bank.shard_of(mid)
            dest = (src + 1) % bank.n_shards
            bank.migrate(mid, dest)
            moved.append((mid, src, dest))
    return after


def lockstep_watch(snaps, gaps):
    """A FedAvg ``run_cell`` watch holding each round to the fused run's
    from the same start: before round t the global model is set to the
    fused run's after round t-1 (``snaps[t - 2]``); after it, its gap to
    the fused run's after round t goes to ``gaps``."""
    def watch(srv):
        inner = srv.run_round

        def run_round(t):
            if t > 1:
                srv.params = snaps[t - 2]
            m = inner(t)
            gaps.append(param_gap(snaps[t - 1], srv.params))
            return m
        srv.run_round = run_round
    return watch


def width_drift(device):
    """The CNN cell's first 16 pairs trained one round (32 SGD steps) in
    one 16-wide call and in four 4-wide calls, from the same params:
    the largest difference (cuDNN's result for a pair depends on the
    batch's width), and the largest after permuting the 16-wide call's
    pairs (it does not depend on their order)."""
    import torch

    from repro_torch.data.bank import DeviceDataBank
    from repro_torch.federated.simulation import make_pair_train

    cfg, params, data, loss_fn, _ = cnn_cell()
    xs, ys = DeviceDataBank(data, device).splits["train"]
    train = make_pair_train(loss_fn, cfg.lr)
    stacked = {k: v.to(device)[None] for k, v in params.items()}
    rng = np.random.default_rng(0)
    perms = rng.integers(0, xs.shape[1], (16, 32, 32)).astype(np.int32)
    m_idx, d_idx = np.zeros(16, np.int32), np.arange(16, dtype=np.int32)
    order = rng.permutation(16)
    with torch.no_grad():
        whole = train(stacked, m_idx, xs, ys, d_idx, perms)
        quarters = [train(stacked, m_idx[i:i + 4], xs, ys, d_idx[i:i + 4],
                          perms[i:i + 4]) for i in range(0, 16, 4)]
        shuffled = train(stacked, m_idx[order], xs, ys, d_idx[order],
                         perms[order])
    back = torch.as_tensor(np.argsort(order), device=device)
    split = max(float((whole[k][i:i + 4] - q[k]).abs().max())
                for k in whole for i, q in zip(range(0, 16, 4), quarters))
    permuted = max(float((whole[k] - shuffled[k][back]).abs().max())
                   for k in whole)
    return split, permuted


def sharded_phase(run_path, device):
    """Phase 13: the sharded planes at full width (phase 5's CNN cell,
    deterministic cuDNN), every cell of a mesh on the one card. Runs the
    ``fused`` FedCD and FedAvg paths, then each of SHARDED_PATHS on its
    injected launch mesh, with its launches held to SHARDED_LAUNCHES
    (``run_path``'s ``expect``) and its discrete state to the fused
    run's. FedCD's params are held to the fused run's within
    SHARDED_INT8_TOL. FedAvg's eq 1 is the reference's plain sum over
    the cells, so its params leave the kernel's by float rounding, which
    the CNN's training amplifies from round to round; each FedAvg path
    therefore also runs in lockstep (every round from the fused run's
    params of the round before), and each of those rounds is held to
    the fused run's at ``SHARDED_F32_TOL`` absolute + relative."""
    import torch

    from repro_torch.core.spec import EngineSpec
    from repro_torch.launch.mesh import make_launch_mesh

    t0 = time.perf_counter()
    split, permuted = width_drift(device)
    print(f"[sharded width drift] 16 pairs, one round: 16-wide vs four "
          f"4-wide calls max_abs_diff={split}, 16-wide vs its permutation "
          f"{permuted}", flush=True)
    if permuted:
        fail("the pairs' order changed their training")
    snaps = []
    refs = {
        "fedcd": run_path("fedcd fused (phase 13)", "fedcd", "fused")[0],
        "fedavg": run_path(
            "fedavg fused (phase 13)", "fedavg", "fused",
            watch=round_hook(lambda srv, t: snaps.append(
                {k: v.detach().cpu().clone()
                 for k, v in srv.params.items()})))[0]}
    placements = {}
    for name, server, (sm, sd), variant in SHARDED_PATHS:
        mesh = make_launch_mesh(sm, sd, devices=[device] * (sm * sd))
        spec = EngineSpec(model_shards=sm, data_shards=sd, mesh=mesh,
                          pipeline=variant == "pipeline")
        expect = dict(zip(("multi_weighted_agg", "quantize", "dequantize"),
                          SHARDED_LAUNCHES[name]))
        moved = []
        srv, walls = run_path(
            name, server, spec, expect=expect,
            watch=(round_hook(migrate_after(moved))
                   if variant == "migrate" else None))
        err, beyond, acc = sharded_err(refs[server], srv, name)
        extra = ""
        if server == "fedcd":
            bank = srv.registry.params
            placements[name] = dict(bank.row_of)
            extra = (f" row_of={bank.row_of} clone_shard="
                     f"{bank.shard_of(1)} owner_shard={bank.shard_of(0)}"
                     f" load_ewma={[round(float(v), 4) for v in bank.load_ewma]}")
            if srv.pipeline:
                extra += f" pipeline_stats={srv.pipeline_stats.as_dict()}"
            if moved:
                extra += f" migrated={moved}"
            if sm > 1 and bank.shard_of(1) == bank.shard_of(0):
                fail(f"{name}: the milestone clone landed on its parent's "
                     f"shard {bank.shard_of(0)}")
        print(f"[sharded {name}] vs fused: discrete state equal, params "
              f"max_abs_err={err} (beyond rel bar {beyond}), accuracy "
              f"max_diff={acc}, walls={[round(w, 4) for w in walls]}"
              f"{extra}", flush=True)
        if server == "fedcd" and err > SHARDED_INT8_TOL:
            fail(f"{name}: params max_abs_err={err} > {SHARDED_INT8_TOL}")
        if variant == "migrate" and (
                not moved
                or placements[name] == placements["fedcd sharded@4"]):
            fail(f"{name}: the forced migration did not move a row")
        if server == "fedavg":
            gaps = []
            run_path(f"{name} lockstep", server, spec, expect=expect,
                     watch=lockstep_watch(snaps, gaps))
            print(f"[sharded {name} lockstep] per-round params max_abs_err="
                  f"{[g for g, _ in gaps]} beyond rel bar "
                  f"{[b for _, b in gaps]}", flush=True)
            if max(b for _, b in gaps) > SHARDED_F32_TOL:
                fail(f"{name}: a lockstep round left the fused one beyond "
                     f"{SHARDED_F32_TOL}")
    torch.cuda.synchronize()
    print(f"[phase 13] {len(SHARDED_PATHS)} sharded paths (FedAvg's twice) "
          f"and 2 fused references in {time.perf_counter() - t0:.2f} s",
          flush=True)


# -- phase 14: the mode-B LM trainer ------------------------------------------

def lm_trainer(arch, fed, dims, spec, device, init, seed=0, mesh=None):
    from repro_torch.config import FedCDConfig
    from repro_torch.federated.llm import FedLLMTrainer
    return FedLLMTrainer(arch, FedCDConfig(**fed), *dims, seed=seed,
                         spec=spec, device=device, init_params=init,
                         mesh=mesh)


def lm_snapshot(tr, on_card=False):
    """A trainer's discrete state, score history, losses and live params
    (on the host; ``on_card``: the params where they lie, for a
    comparison on the card)."""
    return {
        "active": tr.state.active.copy(), "alive": tr.state.alive.copy(),
        "live": tr.registry.live_ids(),
        "genealogy": {m: (e.parent, e.birth_round, e.alive)
                      for m, e in tr.registry.entries.items()},
        "trained": [m.trained_models for m in tr.metrics],
        "live_per_round": [m.live_models for m in tr.metrics],
        "history": tr.state.history.copy(),
        "losses": [m.mean_loss for m in tr.metrics],
        "params": {m: {k: v.detach() if on_card else v.detach().cpu()
                       for k, v in tr.executor.params_of(m).items()}
                   for m in tr.registry.live_ids()},
    }


def lm_compare(a, b, tag):
    """Fail unless two snapshots' discrete state is equal; return the
    score history's and the params' max abs errors."""
    for key in ("active", "alive"):
        if not np.array_equal(a[key], b[key]):
            fail(f"{tag}: {key} masks differ")
    for key in ("live", "genealogy", "trained", "live_per_round"):
        if a[key] != b[key]:
            fail(f"{tag}: {key} differs: {a[key]} != {b[key]}")
    ha, hb = a["history"], b["history"]
    if not np.array_equal(np.isnan(ha), np.isnan(hb)):
        fail(f"{tag}: score histories differ in their empty slots")
    hist = float(np.nanmax(np.abs(ha - hb), initial=0.0))
    perr = 0.0
    for m in a["params"]:
        for k, x in a["params"][m].items():
            y = b["params"][m][k]
            perr = max(perr, float((x.to(y.device).float()
                                    - y.float()).abs().max()))
    return hist, perr


def lm_card_vs_cpu(device, arch, init, seq=LM_SEQ):
    """Phase 14.1: the reduced LM on ``llm``, on the card and on the CPU
    from the same params (float32, TF32 off)."""
    dims = (LM_CLIENTS, LM_PER, seq)
    snaps = {}
    for dev in (device, "cpu"):
        tr = lm_trainer(arch, LM_FED, dims, "llm", dev, init)
        tr.run(LM_ROUNDS)
        snaps[str(dev)] = lm_snapshot(tr)
    card, host = snaps[str(device)], snaps["cpu"]
    hist, perr = lm_compare(card, host, "LM card vs CPU")
    if len(card["genealogy"]) < 2 or all(g[2] for g in
                                         card["genealogy"].values()):
        fail("LM card vs CPU: the schedule made no clone or no deletion")
    print(f"[lm card-vs-cpu] {arch.name} reduced (d_model={arch.d_model}, "
          f"{arch.n_layers} layers, vocab {arch.vocab_size}, seq {seq}) "
          f"{LM_ROUNDS} rounds on llm: discrete state equal, live="
          f"{card['live']}, "
          f"models created={len(card['genealogy'])}, trained per round="
          f"{card['trained']}, history max_abs_err={hist}, params "
          f"max_abs_err={perr}", flush=True)
    if not (hist <= LM_HIST_TOL and perr <= LM_PARAM_TOL):
        fail(f"LM card vs CPU: history {hist} > {LM_HIST_TOL} or params "
             f"{perr} > {LM_PARAM_TOL}")
    return card


def lm_engines(device, arch, init, llm, seq=LM_SEQ):
    """Phase 14.2: legacy and llm+pipeline against llm on the card, and a
    crash at LM_CRASH resumed from the last checkpoint."""
    import tempfile

    from repro_torch.core.spec import EngineSpec
    from repro_torch.data.scenarios import (FaultEvent, FaultSchedule,
                                            SimulatedCrash)
    dims = (LM_CLIENTS, LM_PER, seq)

    def run(spec):
        tr = lm_trainer(arch, LM_FED, dims, spec, device, init)
        tr.run(LM_ROUNDS)
        return lm_snapshot(tr)

    _, legacy_err = lm_compare(llm, run("legacy"), "LM legacy vs llm")
    _, pipe_err = lm_compare(llm, run("llm+pipeline"),
                             "LM llm+pipeline vs llm")
    with tempfile.TemporaryDirectory() as tmp:
        crash = EngineSpec(engine="llm", save_every=LM_CKPT_EVERY,
                           checkpoint_dir=tmp,
                           faults=FaultSchedule((FaultEvent(*LM_CRASH),)))
        try:
            run(crash)
            fail(f"LM crash: no crash at {LM_CRASH}")
        except SimulatedCrash:
            pass
        tr = lm_trainer(arch, LM_FED, dims,
                        EngineSpec(engine="llm", resume_from=tmp), device,
                        init)
        resumed_from = len(tr.metrics)
        tr.run(LM_ROUNDS)
        _, resume_err = lm_compare(llm, lm_snapshot(tr), "LM resume")
    print(f"[lm engines] {arch.name} reduced: legacy == llm == "
          f"llm+pipeline on the card over "
          f"{LM_ROUNDS} rounds: discrete state equal, legacy params "
          f"max_abs_err={legacy_err}, llm+pipeline max_abs_err={pipe_err}; "
          f"crash at {LM_CRASH[1]}@{LM_CRASH[0]}, resumed from round "
          f"{resumed_from}: params max_abs_err={resume_err}", flush=True)
    if legacy_err != 0.0 or pipe_err != 0.0 or resume_err != 0.0:
        fail(f"LM {arch.name}: legacy ({legacy_err}), llm+pipeline "
             f"({pipe_err}) or the resumed run ({resume_err}) is not "
             "bit-equal to llm")
    # the crash comes before its round's save: the last save is earlier
    if resumed_from != (LM_CRASH[0] - 1) // LM_CKPT_EVERY * LM_CKPT_EVERY:
        fail(f"LM resume: resumed from round {resumed_from}")


def lm_transport(device, arch, init, counters, expect=1):
    """Phase 14.3 (15.3): one ``make_train_step(grad_transport_bits=8)``
    step at reduced width on the card, with the transport kernels and
    then with their plain versions; fails unless each kernel launched
    ``expect`` times. Returns the kernels' launch counts."""
    import torch

    from repro_torch.data.tokens import lm_batch
    from repro_torch.kernels.quantize import ops as qops
    from repro_torch.kernels.quantize import ref as qref
    from repro_torch.launch import steps
    from repro_torch.models import frontends

    n, per, seq = LM_TRANSPORT
    tokens, labels = lm_batch(np.random.default_rng(0), n, per, seq,
                              arch.vocab_size)
    tok, lab = (torch.from_numpy(a.astype(np.int64)).to(device)
                for a in (tokens, labels))
    scores = torch.rand(n, generator=torch.Generator().manual_seed(1)
                        ).to(device)
    # an audio model takes encoder frames, and recomputes each layer in
    # the backward pass (1500 frames a row)
    audio = arch.family == "audio"
    frames = (frontends.synthetic_audio_frames(
        torch.Generator().manual_seed(2), arch, n * per, device)
        if audio else None)
    step = steps.make_train_step(arch, lr=0.05, remat=audio,
                                 grad_transport_bits=8)
    kernel_q, kernel_dq = qops.quantize_group, qops.dequantize_group
    seen = {}

    def recording(tag, q_fn):
        def q(xs, bits=8):
            qs, ss = q_fn(xs, bits)
            seen[tag] = ([t.clone() for t in qs], [t.clone() for t in ss])
            return qs, ss
        return q

    def plain_q(xs, bits=8):
        out = [qref.quantize_ref(x, bits) for x in xs]
        return [q for q, _ in out], [s for _, s in out]

    def plain_dq(qs, ss, ns):
        return [qref.dequantize_ref(q, s, (q.shape[0], n), torch.float32)
                for q, s, n in zip(qs, ss, ns)]

    outs = {}
    try:
        for tag, (q_fn, dq_fn) in (("kernel", (kernel_q, kernel_dq)),
                                   ("plain", (plain_q, plain_dq))):
            qops.quantize_group = recording(tag, q_fn)
            qops.dequantize_group = dq_fn
            params = {k: v.to(device, copy=True) for k, v in init.items()}
            for fn in counters:
                fn.launches = 0
            outs[tag], _ = step(params, tok, lab, scores, frames)
            torch.cuda.synchronize()
            if tag == "kernel":
                counts = {fn.__name__: fn.launches for fn in counters}
    finally:
        qops.quantize_group, qops.dequantize_group = kernel_q, kernel_dq
    (kq, ks), (pq, ps) = seen["kernel"], seen["plain"]
    off = max(int((a.int() - b.int()).abs().max()) for a, b in zip(kq, pq))
    frac = (sum(int((a != b).sum()) for a, b in zip(kq, pq))
            / sum(a.numel() for a in kq))
    srel = max(float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())
               for a, b in zip(ks, ps))
    perr = max(float((outs["kernel"][k] - outs["plain"][k]).abs().max())
               for k in outs["kernel"])
    print(f"[lm grad transport] {arch.name} ({arch.n_layers}x"
          f"{arch.d_model}, {arch.param_dtype}), one step of "
          f"{n}x{per}x{seq} tokens, {len(kq)} leaves through the "
          f"transport: codes max_off={off} code_mismatch_share={frac} "
          f"scale_rel_err={srel} params max_abs_err={perr} "
          f"launches={counts} predicted={expect} each", flush=True)
    if off > 1 or frac >= 1e-3 or srel > 1e-6:
        fail("LM grad transport: kernels disagree with the plain versions")
    if counts["quantize"] != expect or counts["dequantize"] != expect:
        fail(f"LM grad transport {arch.name}: {counts} launches, "
             f"predicted {expect} of quantize and of dequantize per step")
    return counts


class LMTimer:
    """Phase 14.4: device time of a trainer's train and eval steps (CUDA
    events around each call). It swaps in steps built exactly as the
    trainer builds its own."""

    def __init__(self, tr):
        import torch

        from repro_torch.federated import simulation as sim
        from repro_torch.federated.llm import make_acc_step
        from repro_torch.launch import steps
        self.events = {"train": [], "eval": []}

        def timed(fn, kind):
            def call(*args, **kw):
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                out = fn(*args, **kw)
                end.record()
                self.events[kind].append((start, end))
                return out
            return call

        from repro_torch.launch.mesh import dp_axes_of
        mesh = tr.mesh
        dp = ("data",) if mesh is None else dp_axes_of(mesh)
        train = timed(steps.make_train_step(tr.arch, mesh, dp,
                                            lr=tr.fed.lr, remat=False),
                      "train")
        acc = timed(make_acc_step(tr.arch, tr.n_clients, mesh, dp,
                                  batch_size=tr.n_clients * tr.per_client),
                    "eval")
        ex = tr.executor
        if hasattr(ex, "_round"):
            ex._round = sim.make_llm_round(train, acc)
            ex._eval = sim.make_llm_eval(acc)
        else:
            ex._train, ex._acc = train, acc

    def take(self):
        import torch
        torch.cuda.synchronize()
        out = {k: sum(s.elapsed_time(e) for s, e in v)
               for k, v in self.events.items()}
        for v in self.events.values():
            v.clear()
        return out


def lm_full_width(device, card_line, name=LM_ARCH, cut=None,
                  specs=("llm", "legacy")):
    """Phase 14.4 (15.4): ``name`` at full width (as registered, bf16,
    but for ``cut``: config overrides, each printed), 4 rounds with a
    milestone clone on each engine of ``specs`` in turn from the same
    random params; the engines' discrete state must agree. Returns each
    spec's per-round losses, trained models, walls and train ms and its
    peak memory."""
    import gc

    import torch

    from repro_torch.config import override
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf
    t_tier = time.perf_counter()
    full = get_arch(name)
    arch = override(full, **cut) if cut else full
    t0 = time.perf_counter()
    init = tf.init_lm(arch, torch.Generator(device=device).manual_seed(0),
                      device=device)
    n_params = sum(v.numel() for v in init.values())
    init = {k: v.cpu() for k, v in init.items()}
    torch.cuda.empty_cache()
    cuts = ", ".join(f"{k} {_field(full, k)} -> {v}"
                     for k, v in (cut or {}).items()) or "nothing"
    print(f"[lm full init] {arch.name}: {n_params} params "
          f"({n_params * 2 / 1e9:.3f} GB bf16) in {len(init)} leaves, "
          f"in {time.perf_counter() - t0:.2f} s; cut: {cuts}", flush=True)
    dims = (FULL_LM_CLIENTS, FULL_LM_PER, FULL_LM_SEQ)
    tokens_per_model = FULL_LM_CLIENTS * FULL_LM_PER * FULL_LM_SEQ
    snaps, records = {}, {}
    for spec in specs:
        torch.cuda.reset_peak_memory_stats()
        tr = lm_trainer(arch, FULL_LM_FED, dims, spec, device, init)
        timer = LMTimer(tr)
        rows = []
        for t in range(1, FULL_LM_ROUNDS + 1):
            t1 = time.perf_counter()
            m = tr.run_round(t)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            split = timer.take()
            tokens = m.trained_models * tokens_per_model
            rows.append((wall, split, tokens))
            print(f"[lm full {arch.name} {spec} round {t}] wall_s="
                  f"{wall:.4f} train_ms={split['train']:.3f} "
                  f"eval_ms={split['eval']:.3f} trained_models="
                  f"{m.trained_models} live={m.live_models} "
                  f"loss={m.mean_loss} tokens={tokens} ({card_line})",
                  flush=True)
            if m.trained_models and not np.isfinite(m.mean_loss):
                fail(f"LM full width {arch.name} {spec}: round {t} loss "
                     f"{m.mean_loss}")
        peak = torch.cuda.max_memory_allocated()
        records[spec] = {
            "losses": [m.mean_loss for m in tr.metrics],
            "trained": [m.trained_models for m in tr.metrics],
            "walls": [r[0] for r in rows],
            "train_ms": [r[1]["train"] for r in rows], "peak": peak}
        later = rows[1:]
        wall = float(np.mean([r[0] for r in later]))
        tok = sum(r[2] for r in later)
        train_ms = sum(r[1]["train"] for r in later)
        eval_ms = sum(r[1]["eval"] for r in later)
        print(f"[lm full {arch.name} {spec}] {arch.n_layers}x"
              f"{arch.d_model} vocab {arch.vocab_size} {arch.param_dtype}, "
              f"{n_params} params, {FULL_LM_CLIENTS} clients x "
              f"{FULL_LM_PER} x {FULL_LM_SEQ} tokens, max_models="
              f"{FULL_LM_FED['max_models']}: mean wall_s rounds "
              f"2-{FULL_LM_ROUNDS}={wall:.4f} walls="
              f"{[round(r[0], 4) for r in rows]} training tokens/s (wall)="
              f"{tok / sum(r[0] for r in later):.1f} training tokens/s "
              f"(train device time)={tok / max(train_ms / 1e3, 1e-9):.1f} "
              f"train_ms={train_ms:.3f} eval_ms={eval_ms:.3f} "
              f"max_memory_allocated={peak} ({peak / 2**30:.2f} GiB) "
              f"({card_line})", flush=True)
        if not any(r[2] for r in rows):
            fail(f"LM full width {arch.name} {spec}: no model trained")
        if len(specs) > 1:
            # the last engine's params stay on the card: the comparison
            # runs there, each leaf of the first copied back
            snaps[spec] = lm_snapshot(tr, on_card=spec == specs[-1])
        del tr, timer
        gc.collect()
        torch.cuda.empty_cache()
    del init
    if len(specs) > 1:
        a, b = specs[0], specs[1]
        hist, perr = lm_compare(snaps[a], snaps[b],
                                f"LM full width {arch.name} {b} vs {a}")
        print(f"[lm full engines] {arch.name}: {a} == {b}: discrete state "
              f"equal, live={snaps[a]['live']}, history max_abs_err={hist}, "
              f"params max_abs_err={perr}", flush=True)
    print(f"[lm full tier] {arch.name}: wall_s="
          f"{time.perf_counter() - t_tier:.1f}", flush=True)
    return records


def _field(cfg, dotted):
    for part in dotted.split("."):
        cfg = getattr(cfg, part)
    return cfg


def lm_phase(device, card_line, counters):
    """Phase 14 (module docstring); returns the launch counts of the
    gradient transport's path and the full-width tier's records."""
    import torch

    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import transformer as tf
    arch = reduced(get_arch(LM_ARCH))
    init = tf.init_lm(arch, torch.Generator().manual_seed(0))
    llm = lm_card_vs_cpu(device, arch, init)
    lm_engines(device, arch, init, llm)
    counts = lm_transport(device, arch, init, counters)
    full = lm_full_width(device, card_line, LM_ARCH, FULL_LM_CUT)
    return counts, full


def moe_phase(device, card_line, counters):
    """Phase 15 (module docstring): phase 14's checks on the MoE / MLA /
    MTP families; returns the launch counts of DeepSeek-V3's gradient
    transport step."""
    import torch

    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import transformer as tf
    counts = None
    for name in MOE_ARCHS:
        arch = reduced(get_arch(name))
        init = tf.init_lm(arch, torch.Generator().manual_seed(0))
        llm = lm_card_vs_cpu(device, arch, init)
        lm_engines(device, arch, init, llm)
        if name == MOE_TRANSPORT[0]:
            counts = lm_transport(device, arch, init, counters,
                                  expect=MOE_TRANSPORT[1])
    for name, cut, specs in FULL_MOE:
        lm_full_width(device, card_line, name, cut, specs)
    return counts


def ssm_phase(device, card_line, counters):
    """Phase 16 (module docstring): phase 14's checks on the xLSTM and
    Zamba2 hybrid families at seq SSM_SEQ; returns the launch counts of
    each gradient transport step, by path name."""
    import torch

    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import transformer as tf
    counts = {}
    for name in SSM_ARCHS:
        arch = reduced(get_arch(name))
        init = tf.init_lm(arch, torch.Generator().manual_seed(0))
        llm = lm_card_vs_cpu(device, arch, init, seq=SSM_SEQ)
        lm_engines(device, arch, init, llm, seq=SSM_SEQ)
    for name, cut_down, expect in SSM_TRANSPORT:
        arch = reduced(get_arch(name)) if cut_down else get_arch(name)
        init = tf.init_lm(arch, torch.Generator().manual_seed(0))
        path = f"lm grad transport {name}" + (" reduced" if cut_down
                                              else "")
        counts[path] = lm_transport(device, arch, init, counters,
                                    expect=expect)
    for name, cut, specs in FULL_SSM:
        arch = get_arch(name)
        chunk = (arch.ssm.chunk if arch.family == "hybrid"
                 else arch.xlstm.chunk)
        print(f"[lm full chunks] {name}: seq {FULL_LM_SEQ} at chunk {chunk}: "
              f"{-(-FULL_LM_SEQ // min(FULL_LM_SEQ, chunk))} chunk(s) a "
              "sequence", flush=True)
        lm_full_width(device, card_line, name, cut, specs)
    return counts


# -- phase 17: the decode path ------------------------------------------------

def gateway_configs():
    """The four tiny decoder configs of tests/test_gateway.py:37-55."""
    from repro_torch.config import ArchConfig, MLAConfig, XLSTMConfig
    common = dict(n_heads=4, d_ff=128, vocab_size=64, d_model=64,
                  param_dtype="float32", compute_dtype="float32")
    return {
        "dense_win": ArchConfig(name="tw", n_layers=2, n_kv_heads=2,
                                sliding_window=6, **common),
        "mla": ArchConfig(name="tm", family="moe", attn_type="mla",
                          n_layers=2, n_kv_heads=4,
                          mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                        qk_nope_dim=16, qk_rope_dim=8,
                                        v_head_dim=16), **common),
        "ssm": ArchConfig(name="ts", family="ssm", n_layers=3, n_kv_heads=4,
                          xlstm=XLSTMConfig(slstm_layers=(1,)), **common),
        "hybrid": ArchConfig(name="th", family="hybrid", n_layers=5,
                             n_kv_heads=4, shared_attn_every=2,
                             shared_attn_lora_rank=4, **common),
    }


def cache_gaps(card, host, tag):
    """Fail unless two cache dicts have the same leaves and equal integer
    leaves; return the largest float gap over its leaf's scale (max |v|,
    at least 1)."""
    if list(card) != list(host):
        fail(f"{tag}: cache leaves differ")
    gap = 0.0
    for k, h in host.items():
        c = card[k].cpu()
        if c.dtype != h.dtype or c.shape != h.shape:
            fail(f"{tag}: cache leaf {k} is {c.dtype} {tuple(c.shape)}, "
                 f"not {h.dtype} {tuple(h.shape)}")
        if not h.dtype.is_floating_point:
            if not bool((c == h).all()):
                fail(f"{tag}: cache leaf {k} differs")
            continue
        scale = max(1.0, float(h.abs().max()))
        gap = max(gap, float((c - h).abs().max()) / scale)
    return gap


def decode_run(cfg, params, prompt, dec, device, frames=None):
    """A prompt's chunked prefill (the last chunk padded), then decode
    steps over ``dec``; an audio config builds its caches from ``frames``
    and decodes only. Returns (the logits of each call, the caches), on
    the host."""
    import torch

    from repro_torch.launch import steps
    from repro_torch.models import encdec as ed
    from repro_torch.models import transformer as tf
    win = cfg.sliding_window
    params = {k: v.to(device) for k, v in params.items()}
    serve = steps.make_serve_step(cfg, window=win)
    logits = []
    with torch.no_grad():
        if frames is not None:
            caches = ed.init_encdec_caches(cfg, params, frames.to(device),
                                           DECODE_MAXLEN)
        else:
            prefill = steps.make_prefill_step(cfg, window=win)
            caches = tf.init_lm_caches(cfg, prompt.shape[0], DECODE_MAXLEN,
                                       window=win, device=device)
            for s in range(0, prompt.shape[1], DECODE_CHUNK):
                chunk = prompt[:, s:s + DECODE_CHUNK]
                nv = chunk.shape[1]
                chunk = torch.nn.functional.pad(chunk,
                                                (0, DECODE_CHUNK - nv))
                last, caches = prefill(params, caches, chunk.to(device), nv)
                logits.append(last)
        for t in range(dec.shape[1]):
            last, caches = serve(params, caches, dec[:, t:t + 1].to(device))
            logits.append(last)
    return ([x.cpu() for x in logits],
            {k: v.cpu() for k, v in caches.items()})


def rollback_check(cfg, params, prompt, device):
    """On ``device``: prefill the prompt, verify a 4-token chunk whose
    draft is rejected at its second token; the rolled-back caches must
    be bitwise the prefill of the accepted prefix."""
    import torch

    from repro_torch.models import transformer as tf
    win = cfg.sliding_window
    params = {k: v.to(device) for k, v in params.items()}
    with torch.no_grad():
        caches = tf.init_lm_caches(cfg, prompt.shape[0], DECODE_MAXLEN,
                                   window=win, device=device)
        _, caches = tf.lm_prefill(cfg, params, prompt[:, :7].to(device),
                                  caches, window=win)
        chunk = prompt[:, 7:].to(device)
        probe, _ = tf.lm_prefill(cfg, params, chunk, caches, window=win)
        draft = torch.argmax(probe, -1).to(torch.int32)[:, :-1]
        draft[:, 1] = (draft[:, 1] + 1) % cfg.vocab_size
        _, n_keep, rolled = tf.lm_spec_verify(cfg, params, chunk, draft,
                                              caches, window=win)
        _, oracle = tf.lm_prefill(cfg, params, chunk, caches, window=win,
                                  n_valid=n_keep)
    if int(n_keep) != 2:
        fail(f"decode {cfg.name}: the verify kept {int(n_keep)} tokens, "
             "not 2")
    return all(torch.equal(rolled[k], oracle[k]) for k in oracle)


def decode_card_vs_cpu(device, drive):
    """Phase 17.1 (module docstring). ``drive(tag, fn)`` runs ``fn`` with
    the launch counters from zero and keeps its counts under ``tag``."""
    import torch

    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import encdec as ed
    from repro_torch.models import frontends
    from repro_torch.models import transformer as tf
    cases = [(name, cfg, None) for name, cfg in gateway_configs().items()]
    cases.append((WHISPER, reduced(get_arch(WHISPER)), True))
    B = DECODE_B
    for name, cfg, audio in cases:
        gen = torch.Generator().manual_seed(0)
        rng = np.random.default_rng(0)
        prompt = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (B, DECODE_PROMPT)))
        dec = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                            (B, DECODE_STEPS)))
        if audio:
            params = ed.init_encdec(cfg, gen)
            frames = frontends.synthetic_audio_frames(gen, cfg, B)
        else:
            params = tf.init_lm(cfg, gen)
            frames = None
        card = drive(f"decode {name}", lambda: decode_run(
            cfg, params, prompt, dec, device, frames))
        host = decode_run(cfg, params, prompt, dec, "cpu", frames)
        lgap = max(float((a - b).abs().max())
                   for a, b in zip(card[0], host[0]))
        cgap = cache_gaps(card[1], host[1], f"decode {name}")
        finite = all(bool(torch.isfinite(x).all()) for x in card[0])
        bitwise = None if audio else rollback_check(cfg, params, prompt,
                                                    device)
        what = (f"caches of {cfg.encdec.source_len} frames, "
                f"{DECODE_STEPS} decode steps" if audio else
                f"prefill of {DECODE_PROMPT} tokens in chunks of "
                f"{DECODE_CHUNK} (the last padded), {DECODE_STEPS} decode "
                "steps")
        print(f"[decode card-vs-cpu] {name} ({cfg.family}, {cfg.n_layers} "
              f"layers, d_model {cfg.d_model}, window {cfg.sliding_window}"
              f"), B={B}, {what}: logits max_abs_err={lgap} cache "
              f"max_err/scale={cgap} index/pos equal, finite={finite}"
              + ("" if audio else
                 f"; rollback after verify == prefill of the accepted "
                 f"prefix on the card: bitwise={bitwise}"), flush=True)
        if not (lgap <= DECODE_LOGIT_TOL and cgap <= DECODE_CACHE_TOL
                and finite and bitwise is not False):
            fail(f"decode {name}: card against CPU logits {lgap} > "
                 f"{DECODE_LOGIT_TOL}, caches {cgap} > {DECODE_CACHE_TOL}, "
                 f"non-finite logits, or rollback not bitwise "
                 f"({bitwise})")


def op_count(fn):
    """The aten operators one call of ``fn`` dispatches, views included:
    each costs the host microseconds, however little the card does."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with Count() as count:
        fn()
    return count.n


def timed(fn):
    """``fn()``'s result and its device milliseconds (CUDA events)."""
    import torch
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def whisper_phase(device, card_line, counters, drive):
    """Phase 17.2 (module docstring): whisper-small whole."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch import steps
    from repro_torch.models import encdec as ed
    from repro_torch.models import frontends
    arch = get_arch(WHISPER)
    gen = torch.Generator(device=device).manual_seed(0)
    params = ed.init_encdec(arch, gen, device=device)
    n_params = sum(v.numel() for v in params.values())
    n, per, seq = WHISPER_DIMS
    B = n * per
    frames = frontends.synthetic_audio_frames(gen, arch, B, device)
    toks = torch.randint(0, arch.vocab_size, (B, seq + 1), generator=gen,
                         device=device)
    tok, lab = toks[:, :-1], toks[:, 1:]
    scores = torch.rand(n, generator=gen, device=device)
    step = steps.make_train_step(arch, lr=0.01)        # per-layer remat
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(params, tok, lab, scores, frames)              # warm-up
    torch.cuda.synchronize()
    step_ms, losses = [], []
    for _ in range(WHISPER_STEPS):
        (params, m), ms = timed(lambda: step(params, tok, lab, scores,
                                             frames))
        step_ms.append(ms)
        losses.append(float(m["loss"]))
    train_peak = torch.cuda.max_memory_allocated()
    # the encoder alone, forward and backward as inside the step: its
    # per-layer leaves, its output's gradient dense
    leaves = {k: v for k, v in steps._grad_leaves(params).items()
              if k.startswith(("enc_blocks.", "enc_norm."))}
    flat = [p for v in leaves.values()
            for p in (v if isinstance(v, list) else [v])]

    def encoder():
        out = ed.encode(arch, leaves, frames, remat=True)
        return torch.autograd.grad(out.float().sum(), flat)

    encoder()
    enc_ms = float(np.mean([timed(encoder)[1] for _ in range(2)]))
    del leaves, flat
    evaluate = steps.make_eval_step(arch, n)
    evaluate(params, tok, lab, frames)
    per_client, eval_ms = timed(lambda: evaluate(params, tok, lab, frames))
    mean_ms = float(np.mean(step_ms))
    print(f"[whisper train] {arch.name} whole: {n_params} params "
          f"({arch.encdec.n_enc_layers}+{arch.n_layers} layers, d_model "
          f"{arch.d_model}, vocab {arch.vocab_size}, {arch.param_dtype}), "
          f"{n} clients x {per} rows x {seq} target tokens on "
          f"{arch.encdec.source_len} source frames, per-layer recompute: "
          f"step device ms={[round(x, 3) for x in step_ms]} mean="
          f"{mean_ms:.3f} target tokens/s={B * seq / mean_ms * 1e3:.1f} "
          f"encoder fwd+bwd ms={enc_ms:.3f} (share {enc_ms / mean_ms:.3f}) "
          f"eval ms={eval_ms:.3f} losses={losses} "
          f"max_memory_allocated={train_peak} "
          f"({train_peak / 2**30:.2f} GiB) ({card_line})", flush=True)
    if not (np.all(np.isfinite(losses))
            and bool(torch.isfinite(per_client).all())):
        fail(f"whisper train: losses {losses}, eval {per_client}")
    # the greedy decode: caches from the same frames, 64 tokens at B=8
    serve = steps.make_serve_step(arch)
    torch.cuda.reset_peak_memory_stats()

    def decode():
        with torch.no_grad():
            caches = ed.init_encdec_caches(arch, params, frames,
                                           WHISPER_DECODE)
        cross = sum(v.nbytes for k, v in caches.items()
                    if k.startswith("cross."))
        ops = op_count(lambda: serve(params, caches, tok[:, :1]))
        outs = []

        def loop(caches, cur):
            for _ in range(WHISPER_DECODE):
                logits, caches = serve(params, caches, cur)
                cur = torch.argmax(logits, -1)[:, None]
                outs.append(logits)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, ms = timed(lambda: loop(caches, tok[:, :1]))
        return cross, ops, outs, ms, time.perf_counter() - t0

    cross, ops, outs, dec_ms, dec_wall = drive(
        f"encdec decode {WHISPER}", decode)
    dec_peak = torch.cuda.max_memory_allocated()
    finite = all(bool(torch.isfinite(x).all()) for x in outs)
    print(f"[whisper decode] {arch.name} whole, greedy, B={B}, "
          f"{WHISPER_DECODE} tokens: device ms/token="
          f"{dec_ms / WHISPER_DECODE:.3f} wall ms/token="
          f"{dec_wall * 1e3 / WHISPER_DECODE:.3f} aten ops/token={ops} "
          f"cross-K/V cache bytes="
          f"{cross} ({cross / 1e6:.1f} MB) finite={finite} "
          f"max_memory_allocated={dec_peak} ({dec_peak / 2**30:.2f} GiB) "
          f"({card_line})", flush=True)
    if not finite:
        fail("whisper decode: non-finite logits")
    init = {k: v.cpu() for k, v in params.items()}
    del params, frames
    torch.cuda.empty_cache()
    return lm_transport(device, arch, init, counters, expect=1)


def qwen_decode_phase(device, card_line, drive):
    """Phase 17.3 (module docstring): Qwen3-4B at phase 14's tier."""
    import gc

    import torch

    from repro_torch.config import override
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    arch = override(get_arch(LM_ARCH), **FULL_LM_CUT)
    gen = torch.Generator(device=device).manual_seed(0)
    params = tf.init_lm(arch, gen, device=device)
    n_params = sum(v.numel() for v in params.values())
    B, P, CH, N = QWEN_DECODE
    prompt = torch.randint(0, arch.vocab_size, (B, P), generator=gen,
                           device=device)
    prefill = steps.make_prefill_step(arch)
    serve = steps.make_serve_step(arch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def run():
        caches = tf.init_lm_caches(arch, B, P + N, device=device)

        def fill(caches):
            for s in range(0, P, CH):
                last, caches = prefill(params, caches, prompt[:, s:s + CH],
                                       CH)
            return last, caches

        (last, caches), pre_ms = timed(lambda: fill(caches))
        kv = sum(v.nbytes for v in caches.values())
        logits = [last]
        toks = [torch.argmax(last, -1)]

        def loop(caches):
            for _ in range(N):
                lg, caches = serve(params, caches, toks[-1][:, None])
                logits.append(lg)
                toks.append(torch.argmax(lg, -1))
            return caches

        caches, dec_ms = timed(lambda: loop(caches))
        ops = op_count(lambda: serve(params, caches, toks[-1][:, None]))
        return pre_ms, dec_ms, ops, kv, torch.stack(logits, 1), \
            torch.stack(toks[:N], 1)

    pre_ms, dec_ms, ops, kv, dec_logits, new = drive(
        f"prefill+decode {LM_ARCH}", run)
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        full, _, _ = tf.lm_forward(arch, params, torch.cat([prompt, new], 1))
    forced = full[:, P - 1:]                        # (B, N + 1, V)
    agree = float((torch.argmax(forced, -1)
                   == torch.argmax(dec_logits, -1)).float().mean())
    gap = float((forced - dec_logits).abs().max())
    finite = bool(torch.isfinite(dec_logits).all()
                  and torch.isfinite(forced).all())
    print(f"[qwen decode] {arch.name} at {arch.n_layers} layers (every "
          f"width kept, {n_params} params, {arch.param_dtype}), B={B}: "
          f"prefill of {P} tokens in chunks of {CH} device ms={pre_ms:.3f} "
          f"({B * P / pre_ms * 1e3:.1f} tokens/s), {N} decode steps device "
          f"ms/token={dec_ms / N:.3f} (aten ops/token={ops}), KV cache "
          f"bytes={kv} "
          f"({kv / 1e9:.3f} GB), max_memory_allocated={peak} "
          f"({peak / 2**30:.2f} GiB); against the teacher-forced forward "
          f"over {P + N} tokens: argmax agreement={agree} (bar "
          f"{QWEN_AGREE}), logits max_abs_diff={gap}, finite={finite} "
          f"({card_line})", flush=True)
    del params, full, forced
    gc.collect()
    torch.cuda.empty_cache()
    if not (finite and agree >= QWEN_AGREE):
        fail(f"qwen decode: argmax agreement {agree} < {QWEN_AGREE} or "
             "non-finite logits")


def decode_phase(device, card_line, counters):
    """Phase 17 (module docstring); returns the launch counts of each of
    its paths, by path name (the decode paths make none)."""
    import torch
    counts = {}

    def drive(tag, fn):
        for f in counters:
            f.launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts[tag] = {f.__name__: f.launches for f in counters}
        if any(counts[tag].values()):
            fail(f"{tag}: kernel launches {counts[tag]}, predicted none")
        return out

    decode_card_vs_cpu(device, drive)
    counts[f"lm grad transport {WHISPER}"] = whisper_phase(
        device, card_line, counters, drive)
    qwen_decode_phase(device, card_line, drive)
    return counts


# -- phase 18: the serving plane ---------------------------------------------

def serve_world(cfg, device):
    """Two models of ``cfg`` (``init_lm`` of seed 0 and a clone perturbed
    by 0.02 N(0, 1)) in a stacked registry on ``device``, and scores by
    which devices 0-3 prefer model 0 and devices 4-7 model 1."""
    import torch

    from repro_torch.core.registry import ModelRegistry
    from repro_torch.core.scores import init_scores, push_accuracies
    from repro_torch.models import transformer as tf
    init = tf.init_lm(cfg, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    clone = {k: v + 0.02 * torch.randn(v.shape, generator=gen)
             for k, v in init.items()}
    reg = ModelRegistry.create({k: v.to(device) for k, v in init.items()},
                               m_cap=4, stacked=True)
    reg.clone(0, 1, {k: v.to(device) for k, v in clone.items()})
    state = init_scores(8, 4, ell=2)
    state.active[:, 1] = True
    state.alive[1] = True
    accs = np.zeros((8, 4))
    accs[:4, 0], accs[:4, 1] = 0.9, 0.1
    accs[4:, 0], accs[4:, 1] = 0.1, 0.9
    return reg, push_accuracies(state, accs)


def lanes_free(gw):
    """Every lane of every pool (draft pools included) is free."""
    pools = [g.pool for g in gw.groups.values()]
    pools += [g.draft_pool for g in gw.groups.values()
              if g.draft_pool is not None]
    return all(p.free_lanes == p.lanes for p in pools)


def serve_small(cfg, device, kw):
    """Phase 18.1, one gateway: the population of :func:`serve_world`,
    one request a device; returns (streams, stats, lanes all free)."""
    from repro_torch.serve import ServeGateway
    n, prompt, new = SERVE_SMALL
    reg, state = serve_world(cfg, device)
    gw = ServeGateway(cfg, reg, lambda: state, **SERVE_SMALL_GW, **kw)
    rng = np.random.default_rng(0)
    reqs = [gw.submit(d, rng.integers(0, cfg.vocab_size, size=prompt),
                      max_new=new) for d in range(n)]
    gw.drain()
    if not all(r.done and len(r.tokens) == new for r in reqs):
        fail(f"serve {cfg.name} {kw}: a request ended short of {new} "
             "tokens")
    return [r.tokens for r in reqs], gw.stats(), lanes_free(gw)


def serve_card_vs_cpu(device, drive):
    """Phase 18.1 (module docstring)."""
    import torch

    from repro_torch.config import ArchConfig
    from repro_torch.serve import KVPool, PagedKVPool
    configs = {"tiny": ArchConfig(
        name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=64, param_dtype="float32",
        compute_dtype="float32"), **gateway_configs()}
    for name, cfg in configs.items():
        runs = {}
        for mode, kw in SERVE_MODES:
            runs[mode] = drive(f"serve {name} {mode}",
                               lambda: serve_small(cfg, device, kw))
            host = serve_small(cfg, "cpu", kw)
            if runs[mode][0] != host[0]:
                fail(f"serve {name} {mode}: greedy streams on the card "
                     f"differ from the CPU's: {runs[mode][0]} != {host[0]}")
        want = runs["vanilla"][0]
        for mode, (streams, st, free) in runs.items():
            pages = st["pools"].get("pages", {}).get("pages_in_use", 0)
            if streams != want or pages or not free:
                fail(f"serve {name} {mode}: streams equal to vanilla="
                     f"{streams == want}, pages in use after the drain="
                     f"{pages}, every lane free={free}")
        lanes, max_len = SERVE_SMALL_GW["lanes"], SERVE_SMALL_GW["max_len"]
        dense = KVPool(cfg, lanes, max_len, device=device)
        paged = PagedKVPool(cfg, lanes, max_len, page_slots=8,
                            device=device)
        for _ in range(lanes):
            paged.acquire()
        shrink = dense.nbytes() / paged.nbytes_in_use()
        spec = runs["spec"][1]["spec"]
        print(f"[serve card-vs-cpu] {name} ({cfg.family}, {cfg.n_layers} "
              f"layers): {SERVE_SMALL[0]} requests, prompt {SERVE_SMALL[1]},"
              f" {SERVE_SMALL[2]} new tokens, {lanes} lanes: greedy streams "
              f"card == CPU in {len(runs)} modes, spec == paged == "
              f"spec+paged == vanilla, pages in use after the drain 0, "
              f"every lane free; dispatches="
              f"{ {m: r[1]['dispatches'] for m, r in runs.items()} } "
              f"tokens_out={runs['vanilla'][1]['tokens_out']} spec "
              f"acceptance={spec['acceptance_rate']:.4f} ({spec['accepted']}"
              f"/{spec['proposed']}); a full pool: dense float32 KV "
              f"{dense.nbytes()} B / paged int8 {paged.nbytes_in_use()} B = "
              f"{shrink:.3f}x", flush=True)
        if name == "tiny" and shrink < SERVE_SHRINK:
            fail(f"serve tiny: paged int8 shrink {shrink:.3f}x < "
                 f"{SERVE_SHRINK}x")
        del dense, paged
    torch.cuda.synchronize()


def serve_batch(gw, devices, prompts, new):
    """Submit one request a (device, prompt) at once and step the gateway
    until it drains; returns (requests, wall s, step walls s, the most
    pool bytes in use at once)."""
    import torch

    def in_use():
        out = gw.pools.nbytes_in_use()
        if gw.draft_pools is not None:
            out += gw.draft_pools.nbytes_in_use()
        return out

    t0 = time.perf_counter()
    reqs = [gw.submit(d, p, new) for d, p in zip(devices, prompts)]
    peak, steps = in_use(), []
    while any(g.has_work() for g in gw.groups.values()):
        t1 = time.perf_counter()
        gw.step()
        steps.append(time.perf_counter() - t1)
        peak = max(peak, in_use())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not all(r.done and len(r.tokens) == new for r in reqs):
        fail(f"serve: a request ended with "
             f"{min(len(r.tokens) for r in reqs)} < {new} tokens")
    return reqs, wall, steps, peak


def serve_report(tag, gw, reqs, wall, steps, peak, card_line):
    """One ``[serve ...]`` line: TTFT, tokens/s, dispatches, batching,
    acceptance, pool bytes."""
    st = gw.stats()
    ttft = np.array([r.ttft_s for r in reqs]) * 1e3
    tokens = sum(len(r.tokens) for r in reqs)
    spec = st.get("spec")
    acc = (f" acceptance={spec['acceptance_rate']:.4f} ({spec['accepted']}"
           f"/{spec['proposed']}, {spec['rounds']} rounds, draft "
           f"{spec['draft_layers']} layers, draft pool bytes in use after "
           f"the drain={spec['draft_pool_bytes_in_use']})" if spec else "")
    pages = st["pools"].get("pages")
    print(f"[serve {tag}] {len(reqs)} requests: TTFT ms p50="
          f"{np.percentile(ttft, 50):.1f} p95={np.percentile(ttft, 95):.1f}"
          f" max={ttft.max():.1f}; {tokens} tokens in {wall:.3f} s = "
          f"{tokens / wall:.1f} tokens/s of wall; {len(steps)} steps, step "
          f"ms mean={np.mean(steps) * 1e3:.1f} p50="
          f"{np.percentile(steps, 50) * 1e3:.1f}; dispatches="
          f"{st['dispatches']} tokens_out={st['tokens_out']} batching "
          f"efficiency={st['batching_efficiency']}{acc}; pool bytes "
          f"reserved={st['pools']['bytes']} most in use={peak}"
          + (f" pages={pages}" if pages else "") + f" ({card_line})",
          flush=True)
    if pages and pages["pages_in_use"]:
        fail(f"serve {tag}: {pages['pages_in_use']} pages in use after the "
             "drain")
    if not lanes_free(gw):
        fail(f"serve {tag}: a lane is still held after the drain")


def agreement(a, b):
    """The share of positions where two runs' token streams agree."""
    same = sum(int(x == y) for ra, rb in zip(a, b)
               for x, y in zip(ra.tokens, rb.tokens))
    return same / sum(len(r.tokens) for r in a)


def serve_full_width(device, card_line, drive):
    """Phase 18.2 (module docstring)."""
    import gc

    import torch

    from repro_torch.config import FedCDConfig, override
    from repro_torch.configs import get_arch
    from repro_torch.federated.llm import FedLLMTrainer
    from repro_torch.models import transformer as tf
    from repro_torch.serve import KVPool, PagedKVPool, ServeGateway
    t_tier = time.perf_counter()
    arch = override(get_arch(LM_ARCH), **FULL_LM_CUT)
    torch.cuda.reset_peak_memory_stats()
    init = tf.init_lm(arch, torch.Generator(device=device).manual_seed(0),
                      device=device)
    n_params = sum(v.numel() for v in init.values())

    def train(rounds):
        tr = FedLLMTrainer(arch, FedCDConfig(**FULL_LM_FED),
                           FULL_LM_CLIENTS, FULL_LM_PER, FULL_LM_SEQ,
                           seed=0, spec="llm", device=device,
                           init_params=init,
                           draft_layers=SERVE_DRAFT_LAYERS)
        for t in range(1, rounds + 1):
            tr.run_round(t)
            if len(tr.registry.live_ids()) >= 2:
                break
        return tr

    t0 = time.perf_counter()
    tr = drive(f"serve {LM_ARCH} train", lambda: train(FULL_LM_ROUNDS))
    del init
    gc.collect()
    live = tr.registry.live_ids()
    print(f"[serve {LM_ARCH} population] {arch.n_layers} layers (every "
          f"width kept, {n_params} params a model, {arch.param_dtype}), "
          f"{len(tr.metrics)} rounds of llm in "
          f"{time.perf_counter() - t0:.2f} s: live={live}, draft rows "
          f"{sorted(tr.draft.present)} of {tr.draft.dcfg.n_layers} layers "
          f"({tr.draft.nbytes()} B)", flush=True)
    if len(live) < 2:
        fail(f"serve {LM_ARCH}: the trainer left {len(live)} live model")
    n, prompt, new = SERVE_FULL
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, arch.vocab_size, (n, prompt))
    devices = [i % FULL_LM_CLIENTS for i in range(n)]
    runs, gws = {}, {}
    for mode, kw in SERVE_FULL_MODES:
        if "spec_k" in kw:
            kw = dict(kw, draft=tr.draft)
        gw = ServeGateway(arch, tr.registry, lambda: tr.state,
                          **SERVE_FULL_GW, **kw)
        out = drive(f"serve {LM_ARCH} {mode}", lambda: serve_batch(
            gw, devices, prompts, new))
        serve_report(f"{LM_ARCH} {mode}", gw, *out, card_line)
        runs[mode], gws[mode] = out[0], gw
    agree = {m: agreement(runs[m], runs["vanilla"])
             for m in runs if m != "vanilla"}
    # one vmapped decode step of a full group alone: its host cost
    gw = gws["vanilla"]
    group = next(iter(gw.groups.values()))
    params = {k: v[tr.registry.params.row_of[group.model]]
              for k, v in tr.registry.params.tree.items()}
    toks = torch.zeros(SERVE_FULL_GW["lanes"], dtype=torch.long,
                       device=device)
    with torch.no_grad():
        ops = op_count(lambda: gw._decode(params, group.pool.read(), toks))
        walls = []
        for _ in range(5):
            t1 = time.perf_counter()
            gw._decode(params, group.pool.read(), toks)[1].cpu()
            walls.append((time.perf_counter() - t1) * 1e3)
    print(f"[serve {LM_ARCH} step] one vmapped decode step of "
          f"{SERVE_FULL_GW['lanes']} lanes: aten ops={ops}, wall ms="
          f"{[round(w, 2) for w in walls]} ({card_line})", flush=True)
    # one full pool of the tier: dense bf16 KV against paged int8
    lanes, max_len = SERVE_FULL_GW["lanes"], SERVE_FULL_GW["max_len"]
    dense = KVPool(arch, lanes, max_len, device=device)
    paged = PagedKVPool(arch, lanes, max_len, page_slots=8, device=device)
    for _ in range(lanes):
        paged.acquire()
    print(f"[serve {LM_ARCH} kv] one pool of {lanes} lanes x {max_len} "
          f"slots: dense {arch.compute_dtype} KV {dense.nbytes()} B, paged "
          f"int8 bytes_in_use {paged.nbytes_in_use()} B = "
          f"{dense.nbytes() / paged.nbytes_in_use():.3f}x; tokens equal to "
          f"vanilla's: spec {agree['spec']:.4f}, paged {agree['paged']:.4f}"
          f" (bf16 near-ties and int8 KV: reported, not held)", flush=True)
    del dense, paged, gws["spec"], gws["paged"]
    # one more round, the gateway re-synced, a second batch
    gw = gws["vanilla"]
    t1 = time.perf_counter()
    drive(f"serve {LM_ARCH} round", lambda: tr.run_round(len(tr.metrics)
                                                          + 1))
    out = gw.sync()
    print(f"[serve {LM_ARCH} sync] round {len(tr.metrics)} in "
          f"{time.perf_counter() - t1:.2f} s, live="
          f"{tr.registry.live_ids()}; sync: {out}; routing="
          f"{gw.stats()['routing']}", flush=True)
    prompts = np.random.default_rng(1).integers(0, arch.vocab_size,
                                                (n, prompt))
    res = drive(f"serve {LM_ARCH} after sync", lambda: serve_batch(
        gw, devices, prompts, new))
    serve_report(f"{LM_ARCH} after sync", gw, *res, card_line)
    peak = torch.cuda.max_memory_allocated()
    print(f"[serve {LM_ARCH} tier] max_memory_allocated={peak} "
          f"({peak / 2**30:.2f} GiB), wall_s="
          f"{time.perf_counter() - t_tier:.1f} ({card_line})", flush=True)
    del gw, gws, tr
    gc.collect()
    torch.cuda.empty_cache()


def serve_phase(device, card_line, counters):
    """Phase 18 (module docstring); returns the launch counts of each of
    its paths, by path name (the serving paths make none)."""
    import torch
    counts = {}

    def drive(tag, fn):
        for f in counters:
            f.launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts[tag] = {f.__name__: f.launches for f in counters}
        if any(counts[tag].values()):
            fail(f"{tag}: kernel launches {counts[tag]}, predicted none")
        return out

    serve_card_vs_cpu(device, drive)
    serve_full_width(device, card_line, drive)
    return counts


# -- phase 19: the tensor-parallel LM mesh --------------------------------------

def mesh_arch(name):
    """The tiny LM of tests/test_llm_equivalence.py, or a reduced arch."""
    from repro_torch.config import ArchConfig
    from repro_torch.configs import get_arch, reduced
    if name == "tiny":
        return ArchConfig(name="tiny", n_layers=2, d_model=64, n_heads=4,
                          n_kv_heads=2, d_ff=128, vocab_size=64,
                          param_dtype="float32", compute_dtype="float32")
    return reduced(get_arch(name))


def card_mesh(device, model, data):
    from repro_torch.launch.mesh import make_launch_mesh
    return make_launch_mesh(model, data, devices=[device] * (model * data))


def mesh_card_vs_cpu(device, drive):
    """Phase 19.1: each of MESH_ARCHS over LM_ROUNDS rounds on ``llm`` on
    each mesh of MESH_SHAPES (cells on the card) against the one-device
    run on the card (MESH_PARAM_TOL; not for MoE at data > 1, whose
    capacity is per data shard) and the same mesh on the CPU
    (LM_PARAM_TOL, phase 14's card-against-CPU bar). No path launches a
    kernel."""
    import torch

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tf
    dims = (LM_CLIENTS, LM_PER, LM_SEQ)

    def run(arch, init, device=None, mesh=None):
        t0 = time.perf_counter()
        tr = lm_trainer(arch, LM_FED, dims, "llm", device, init, mesh=mesh)
        tr.run(LM_ROUNDS)
        return lm_snapshot(tr), time.perf_counter() - t0

    for name in MESH_ARCHS:
        arch = mesh_arch(name)
        init = tf.init_lm(arch, torch.Generator().manual_seed(0))
        one, _ = drive(f"lm mesh {name} one-device",
                       lambda: run(arch, init, device=device))
        for m, d in MESH_SHAPES:
            tag = f"lm mesh {name} {m}x{d}"
            card, wall = drive(tag, lambda: run(
                arch, init, mesh=card_mesh(device, m, d)))
            host, _ = run(arch, init, mesh=make_host_mesh(model=m, data=d))
            hist, cpu_err = lm_compare(card, host, f"{tag} card vs CPU")
            vs_one = not (arch.moe.n_experts and d > 1)
            one_err = (lm_compare(card, one, f"{tag} vs one device")[1]
                       if vs_one else None)
            print(f"[{tag}] {arch.name} ({arch.n_layers}x{arch.d_model}, "
                  f"{LM_ROUNDS} rounds, cells on the card): discrete state "
                  f"equal to the CPU mesh's"
                  f"{' and the one-device run' if vs_one else ''}, live="
                  f"{card['live']}, trained={card['trained']}, history "
                  f"max_abs_err={hist}, params max_abs_err vs CPU="
                  f"{cpu_err}, vs one device={one_err}, wall_s="
                  f"{wall:.2f}", flush=True)
            if cpu_err > LM_PARAM_TOL or hist > LM_HIST_TOL or (
                    vs_one and one_err > MESH_PARAM_TOL):
                fail(f"{tag}: params {cpu_err} (CPU) / {one_err} (one "
                     f"device) or history {hist} beyond the bars")


def mesh_transport_rows(arch, init, mesh):
    """Predicted rows of the mesh step's transport on each device: a leaf
    of 128 values or more is one row per distinct block when every row
    of every piece is a whole number of the whole leaf's 128-value
    blocks, else one row (gathered) on cell (0, 0)."""
    import torch

    from repro_torch.launch.sharding import lm_bank_shardings
    from repro_torch.launch.tensor_parallel import cell_blocks, narrow_block
    from repro_torch.models import transformer as tf
    rows = {}
    for k, sh in lm_bank_shardings(arch, init, mesh).items():
        depth = tf.stacked_depth(k)
        shape = tuple(init[k].shape[depth:])
        if init[k].numel() < 128:
            continue
        spec = sh.spec[1 + depth:]
        idx = torch.arange(int(np.prod(shape))).reshape(shape)
        blocks = {}
        for blk, dev in zip(cell_blocks(mesh, spec), mesh.devices):
            blocks.setdefault(blk, dev)

        def whole_blocks(blk):
            flat = narrow_block(idx, blk).reshape(-1)
            if flat.numel() % 128:
                return False
            runs = flat.view(-1, 128)
            return bool((runs[:, 0] % 128 == 0).all()
                        and (runs[:, 1:] - runs[:, :-1] == 1).all())

        if all(whole_blocks(b) for b in blocks):
            for dev in blocks.values():
                rows[dev] = rows.get(dev, 0) + 1
        else:
            dev = mesh.device(0, 0)
            rows[dev] = rows.get(dev, 0) + 1
    return rows


def mesh_transport(device, drive):
    """Phase 19.1: one ``grad_transport_bits=8`` step of each of
    MESH_TRANSPORT_ARCHS on each mesh of MESH_SHAPES (cells on the
    card): launches of each kernel predicted from the pieces' layout
    (``mesh_transport_rows``, 32 rows a launch on each device); the
    kernels' codes and scales against their plain versions on the same
    rows; the transported gradient equal, bit for bit, to the transport
    of the same gradient gathered whole (the whole leaf's blocks)."""
    import math

    import torch

    from repro_torch.core.registry import StackedParamBank
    from repro_torch.data.tokens import lm_batch
    from repro_torch.kernels.quantize import ops as qops
    from repro_torch.kernels.quantize import ref as qref
    from repro_torch.launch import steps
    from repro_torch.launch.sharding import lm_bank_shardings
    from repro_torch.launch.tensor_parallel import Sharded
    from repro_torch.models import transformer as tf
    n, per, seq = LM_TRANSPORT
    scores = torch.rand(n, generator=torch.Generator().manual_seed(1)
                        ).to(device)
    cap = qops.max_leaves()
    for name, (m, d) in ((a, md) for a in MESH_TRANSPORT_ARCHS
                         for md in MESH_SHAPES):
        arch = mesh_arch(name)
        init = tf.init_lm(arch, torch.Generator().manual_seed(0))
        tokens, labels = lm_batch(np.random.default_rng(0), n, per, seq,
                                  arch.vocab_size)
        tok, lab = (torch.from_numpy(a.astype(np.int64)).to(device)
                    for a in (tokens, labels))
        mesh = card_mesh(device, m, d)
        tag = f"lm mesh grad transport {name} {m}x{d}"
        bank = StackedParamBank(1, init,
                                shardings=lm_bank_shardings(arch, init,
                                                            mesh))
        bank[0] = init
        rows = mesh_transport_rows(arch, init, mesh)
        expect = sum(math.ceil(r / cap) for r in rows.values())
        seen, grads = [], {}
        real_q, real_t = qops.quantize_group, steps.quantize_grads

        def q(xs, bits=8):
            qs, ss = real_q(xs, bits)
            seen.append(([x.clone() for x in xs], [t.clone() for t in qs],
                         [t.clone() for t in ss]))
            return qs, ss

        def t(g, bits=8):
            grads["in"], grads["out"] = g, real_t(g, bits)
            return grads["out"]

        step = steps.make_train_step(arch, mesh, lr=0.05, remat=False,
                                     grad_transport_bits=8)
        qops.quantize_group, steps.quantize_grads = q, t
        try:
            _, counts = drive(tag, lambda: step(bank[0], tok, lab, scores),
                              check=False)
        finally:
            qops.quantize_group, steps.quantize_grads = real_q, real_t
        got = (counts["quantize"], counts["dequantize"])
        off = frac_n = frac_d = 0
        srel = 0.0
        for xs, qs, ss in seen:
            for x, qk, sk in zip(xs, qs, ss):
                qp, sp = qref.quantize_ref(x, 8)
                off = max(off, int((qk.int() - qp.int()).abs().max()))
                frac_n += int((qk != qp).sum())
                frac_d += qk.numel()
                srel = max(srel, float(((sk - sp).abs()
                                        / sp.abs().clamp(min=1e-30)).max()))
        home = mesh.device(0, 0)

        def whole(v):
            parts = v if isinstance(v, list) else [v]
            return [p.full(home) if isinstance(p, Sharded) else p
                    for p in parts]

        ref = steps.quantize_grads({k: whole(v) for k, v in
                                    grads["in"].items()})
        same = all(torch.equal(a, b) for k in ref
                   for a, b in zip(whole(grads["out"][k]), ref[k]))
        print(f"[{tag}] {arch.name} ({arch.n_layers}x{arch.d_model}), "
              f"one step of {n}x{per}x{seq} tokens: rows per device="
              f"{ {str(k): v for k, v in rows.items()} } "
              f"launches (quantize, dequantize)={got} predicted="
              f"{(expect, expect)}; codes max_off={off} "
              f"code_mismatch_share={frac_n / max(frac_d, 1)} "
              f"scale_rel_err={srel}; equal to the whole leaves' "
              f"transport={same}", flush=True)
        if got != (expect, expect):
            fail(f"{tag}: launches {got}, predicted {expect} of each")
        if off > 1 or frac_n >= 1e-3 * frac_d or srel > 1e-6 or not same:
            fail(f"{tag}: codes or scales disagree")


def mesh_full_width(device, card_line, drive, ref):
    """Phase 19.2: Qwen3-4B at phase 14's tier on ``llm`` at
    ``model=MESH_FULL_MODEL`` (cells on the card) for MESH_FULL_ROUNDS
    rounds from phase 14's params: step ms, round walls, peak memory,
    and the losses and trained models beside phase 14's one-device
    ``llm`` run (``ref``)."""
    import gc

    import torch

    from repro_torch.config import override
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tf
    arch = override(get_arch(LM_ARCH), **FULL_LM_CUT)
    init = tf.init_lm(arch, torch.Generator(device=device).manual_seed(0),
                      device=device)
    init = {k: v.cpu() for k, v in init.items()}
    torch.cuda.empty_cache()
    dims = (FULL_LM_CLIENTS, FULL_LM_PER, FULL_LM_SEQ)
    mesh = card_mesh(device, MESH_FULL_MODEL, 1)
    tag = f"lm mesh full {arch.name} model={MESH_FULL_MODEL}"

    def run():
        torch.cuda.reset_peak_memory_stats()
        tr = lm_trainer(arch, FULL_LM_FED, dims, "llm", None, init,
                        mesh=mesh)
        timer = LMTimer(tr)
        rows = []
        for t in range(1, MESH_FULL_ROUNDS + 1):
            t1 = time.perf_counter()
            m = tr.run_round(t)
            torch.cuda.synchronize()
            rows.append((time.perf_counter() - t1, timer.take(), m))
        return tr, rows, torch.cuda.max_memory_allocated()

    tr, rows, peak = drive(tag, run)
    losses = [r[2].mean_loss for r in rows]
    trained = [r[2].trained_models for r in rows]
    one = ref["llm"]
    n = len(rows)
    step_ms = [r[1]["train"] / max(r[2].trained_models, 1) for r in rows]
    one_ms = [ms / max(k, 1) for ms, k in zip(one["train_ms"][:n],
                                              one["trained"][:n])]
    pairs = list(zip(losses, one["losses"][:n]))
    if any(np.isnan(a) != np.isnan(b) for a, b in pairs):
        fail(f"{tag}: losses {losses} trained in other rounds than the "
             f"one-device run's {one['losses'][:n]}")
    dl = max((abs(a - b) for a, b in pairs if not np.isnan(a)),
             default=0.0)
    print(f"[{tag}] {arch.n_layers}x{arch.d_model} vocab "
          f"{arch.vocab_size} {arch.param_dtype}, {n} rounds: step ms="
          f"{[round(x, 3) for x in step_ms]} (one device, phase 14: "
          f"{[round(x, 3) for x in one_ms]}), round walls_s="
          f"{[round(r[0], 4) for r in rows]} (one device: "
          f"{[round(w, 4) for w in one['walls'][:n]]}), train_ms="
          f"{[round(r[1]['train'], 3) for r in rows]}, eval_ms="
          f"{[round(r[1]['eval'], 3) for r in rows]}, trained={trained} "
          f"(one device {one['trained'][:n]}), losses={losses} (one "
          f"device {one['losses'][:n]}), max loss diff={dl}, "
          f"max_memory_allocated={peak} ({peak / 2**30:.2f} GiB; one "
          f"device {one['peak'] / 2**30:.2f} GiB) ({card_line})",
          flush=True)
    if trained != one["trained"][:n] or not dl <= MESH_LOSS_TOL:
        fail(f"{tag}: trained {trained} / losses {losses} against the one-"
             f"device run's {one['trained'][:n]} / {one['losses'][:n]}")
    del rows
    gc.collect()
    torch.cuda.empty_cache()
    return tr


def mesh_phase(device, card_line, counters, qwen_full):
    """Phase 19 (module docstring); returns each path's launch counts,
    by path name, and 19.2's trainer (phase 20 serves its bank)."""
    import torch
    counts = {}

    def drive(tag, fn, check=True):
        for f in counters:
            f.launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts[tag] = {f.__name__: f.launches for f in counters}
        if check and any(counts[tag].values()):
            fail(f"{tag}: kernel launches {counts[tag]}, predicted none")
        return out if check else (out, counts[tag])

    mesh_card_vs_cpu(device, drive)
    mesh_transport(device, drive)
    tr = mesh_full_width(device, card_line, drive, qwen_full)
    return counts, tr


# -- phase 20: the decode path on the mesh ------------------------------------

def mesh_decode_run(cfg, params, toks, device, mesh=None):
    """Phase 20.1, one run: the prompt's chunked prefill (the last chunk
    padded), decode steps, a verify whose draft is rejected at its second
    token and a propose of 3 from its accepted prefix. Returns the
    logits of each call, the caches after the decodes, the verify's
    (outputs, n_keep, caches) and the propose's (proposals, caches), on
    the host."""
    import torch

    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    B, P, CH, N, L = MESH_DECODE
    prompt, dec, chunk = (t.to(device) for t in toks)
    params = {k: v.to(device) for k, v in params.items()}
    prefill = steps.make_prefill_step(cfg, mesh=mesh)
    serve = steps.make_serve_step(cfg, mesh=mesh)

    def host(c):
        return {k: v.cpu() for k, v in c.items()}

    with torch.no_grad():
        c = tf.init_lm_caches(cfg, B, L, device=device)
        logits = []
        for s in range(0, P, CH):
            part = prompt[:, s:s + CH]
            nv = part.shape[1]
            part = torch.nn.functional.pad(part, (0, CH - nv))
            last, c = prefill(params, c, part, nv)
            logits.append(last)
        for t in range(N):
            last, c = serve(params, c, dec[:, t:t + 1])
            logits.append(last)
        probe, _ = tf.lm_prefill(cfg, params, chunk, c, mesh=mesh)
        draft = torch.argmax(probe, -1).to(torch.int32)[:, :-1]
        draft[:, 1] = (draft[:, 1] + 1) % cfg.vocab_size
        out, nk, vc = tf.lm_spec_verify(cfg, params, chunk, draft, c,
                                        mesh=mesh)
        cur = torch.index_select(out, 1, (nk - 1).long().reshape(1))
        props, pc = tf.lm_spec_propose(cfg, params, chunk, nk, cur, 3, c,
                                       mesh=mesh)
    return ([x.cpu() for x in logits], host(c),
            (out.cpu(), int(nk), host(vc)), (props.cpu(), host(pc)))


def mesh_decode_gaps(a, b, tag):
    """Fail unless two :func:`mesh_decode_run` results agree on every
    discrete output; return (logits max_abs_err, cache max_err/scale)."""
    import torch
    lgap = max(float((x - y).abs().max()) for x, y in zip(a[0], b[0]))
    cgap = max(cache_gaps(a[1], b[1], tag), cache_gaps(a[2][2], b[2][2], tag),
               cache_gaps(a[3][1], b[3][1], tag))
    if not (torch.equal(a[2][0], b[2][0]) and a[2][1] == b[2][1]
            and torch.equal(a[3][0], b[3][0])):
        fail(f"{tag}: verify outputs, n_keep or proposals differ")
    return lgap, cgap


def mesh_decode_card_vs_cpu(device, drive):
    """Phase 20.1: the decode path of each of MESH_DECODE_ARCHS on each
    mesh of MESH_SHAPES (cells on the card) against the one-device run on
    the card and the same mesh on the CPU, at phase 17's bars."""
    import torch

    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tf
    B, P, CH, N, L = MESH_DECODE
    for name in MESH_DECODE_ARCHS:
        cfg = reduced(get_arch(name))
        params = tf.init_lm(cfg, torch.Generator().manual_seed(0))
        rng = np.random.default_rng(0)
        toks = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, n)))
                for n in (P, N, 4)]
        one = drive(f"mesh decode {name} one-device",
                    lambda: mesh_decode_run(cfg, params, toks, device))
        for m, d in MESH_SHAPES:
            tag = f"mesh decode {name} {m}x{d}"
            t0 = time.perf_counter()
            card = drive(tag, lambda: mesh_decode_run(
                cfg, params, toks, device, card_mesh(device, m, d)))
            wall = time.perf_counter() - t0
            host = mesh_decode_run(cfg, params, toks, "cpu",
                                   make_host_mesh(model=m, data=d))
            l_one, c_one = mesh_decode_gaps(card, one, tag + " vs one")
            l_cpu, c_cpu = mesh_decode_gaps(card, host, tag + " vs CPU")
            finite = all(bool(torch.isfinite(x).all()) for x in card[0])
            print(f"[{tag}] {cfg.name} ({cfg.family}, {cfg.n_layers} layers, "
                  f"d_model {cfg.d_model}), B={B}: prefill of {P} tokens in "
                  f"chunks of {CH} (the last padded), {N} decode steps, a "
                  f"verify kept {card[2][1]} of 4, a propose of 3: against "
                  f"one device logits max_abs_err={l_one} cache max_err/"
                  f"scale={c_one}; against the CPU mesh {l_cpu} / {c_cpu}; "
                  f"index/pos, verify outputs and proposals equal, finite="
                  f"{finite}, wall_s={wall:.2f}", flush=True)
            if not (max(l_one, l_cpu) <= DECODE_LOGIT_TOL
                    and c_one <= DECODE_CACHE_TOL and finite
                    and c_cpu <= MESH_DECODE_CPU_CACHE_TOL.get(
                        name, DECODE_CACHE_TOL)):
                fail(f"{tag}: logits {l_one} / {l_cpu} or caches {c_one} / "
                     f"{c_cpu} beyond the bars, or non-finite logits")


def mesh_serve(cfg, registry, state, draft, kw):
    """One gateway over ``registry`` serving SERVE_SMALL's requests;
    returns the greedy streams."""
    from repro_torch.serve import ServeGateway
    if "spec_k" in kw:
        kw = dict(kw, draft=draft)
    n, prompt, new = SERVE_SMALL
    gw = ServeGateway(cfg, registry, lambda: state, **SERVE_SMALL_GW, **kw)
    rng = np.random.default_rng(0)
    reqs = [gw.submit(d, rng.integers(0, cfg.vocab_size, size=prompt),
                      max_new=new) for d in range(n)]
    gw.drain()
    if not (all(r.done and len(r.tokens) == new for r in reqs)
            and lanes_free(gw)):
        fail(f"mesh serve {kw}: a request ended short of {new} tokens or "
             "a lane is still held")
    return [r.tokens for r in reqs]


def mesh_serve_card(device, drive):
    """Phase 20.1: the tiny LM trained on ``model=2`` (cells on the card,
    1-layer draft rows) for MESH_SERVE_ROUNDS rounds, served from its
    sharded bank in the four gateway modes; the streams must equal the
    one-device gateway's on the bank gathered, mode by mode."""
    import copy

    import torch

    from repro_torch.config import FedCDConfig
    from repro_torch.federated.llm import FedLLMTrainer
    from repro_torch.models import transformer as tf
    cfg = mesh_arch("tiny")
    init = tf.init_lm(cfg, torch.Generator().manual_seed(0))
    tr = FedLLMTrainer(cfg, FedCDConfig(**dict(LM_FED, n_devices=8)), 8,
                       LM_PER, LM_SEQ, n_archetypes=2, seed=0, spec="llm",
                       mesh=card_mesh(device, 2, 1), init_params=init,
                       draft_layers=1)
    tr.run(MESH_SERVE_ROUNDS)
    one = copy.copy(tr.registry)
    one.params = tr.registry.params.gathered()
    same = {}
    for mode, kw in MESH_SERVE_MODES:
        streams = drive(f"mesh serve tiny {mode}", lambda: mesh_serve(
            cfg, tr.registry, tr.state, tr.draft, kw))
        want = mesh_serve(cfg, one, tr.state, tr.draft, kw)
        same[mode] = streams == want
    print(f"[mesh serve tiny] {cfg.name} trained {MESH_SERVE_ROUNDS} rounds "
          f"on model=2 (cells on the card), live="
          f"{tr.registry.live_ids()}: {SERVE_SMALL[0]} requests, prompt "
          f"{SERVE_SMALL[1]}, {SERVE_SMALL[2]} new tokens, greedy streams "
          f"equal to the one-device gateway on the bank gathered: {same}",
          flush=True)
    if not all(same.values()):
        fail(f"mesh serve tiny: streams differ from one device: {same}")


def flip_gaps(ref_logits, other_logits, ref_toks, other_toks):
    """Classify greedy flips between two streams of one batch (lists of
    (B, V) logits and (B,) tokens a step): the bf16 noise bar is the
    largest logit difference of the two runs at the steps where each
    lane's context is still the same and its tokens agree; each lane's
    first differing token (later ones follow from its context) gets the
    reference logits' top-2 gap. Returns (bar, [(lane, step, gap)])."""
    import torch
    B = ref_toks[0].shape[0]
    bar, flips = 0.0, []
    for lane in range(B):
        for t, (ra, oa) in enumerate(zip(ref_toks, other_toks)):
            if int(ra[lane]) != int(oa[lane]):
                top = torch.topk(ref_logits[t][lane].float(), 2).values
                flips.append((lane, t, float(top[0] - top[1])))
                break
            bar = max(bar, float((ref_logits[t][lane].float()
                                  - other_logits[t][lane].float()
                                  ).abs().max()))
    return bar, flips


def mesh_qwen_decode(arch, params, device, mesh, prompt):
    """Phase 20.2, one run: MESH_QWEN's prompt in one prefill, then greedy
    decode steps; returns (prefill ms, decode ms, aten ops a token, peak
    bytes, logits a step, tokens a step)."""
    import torch

    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    B, P, N = MESH_QWEN
    prefill = steps.make_prefill_step(arch, mesh=mesh)
    serve = steps.make_serve_step(arch, mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    caches = tf.init_lm_caches(arch, B, P + N, device=device)
    (last, caches), pre_ms = timed(lambda: prefill(params, caches, prompt,
                                                   P))
    logits, toks = [last], [torch.argmax(last, -1)]

    def loop(caches):
        for _ in range(N):
            lg, caches = serve(params, caches, toks[-1][:, None])
            logits.append(lg)
            toks.append(torch.argmax(lg, -1))
        return caches

    caches, dec_ms = timed(lambda: loop(caches))
    ops = op_count(lambda: serve(params, caches, toks[-1][:, None]))
    peak = torch.cuda.max_memory_allocated()
    return (pre_ms, dec_ms, ops, peak, [x.cpu() for x in logits],
            [x.cpu() for x in toks])


def mesh_qwen_phase(device, card_line, drive, tr):
    """Phase 20.2 (module docstring): Qwen3-4B at phase 14's tier from
    the bank phase 19.2 trained on ``model=MESH_FULL_MODEL``."""
    import copy
    import gc

    import torch

    from repro_torch.serve import ServeGateway
    arch = tr.arch
    bank = tr.registry.params
    mesh = bank.tree["embed.table"].mesh
    m0 = tr.registry.live_ids()[0]
    row = bank[m0]
    whole = {k: v.full(device) for k, v in row.items()}
    B, P, N = MESH_QWEN
    gen = torch.Generator(device=device).manual_seed(0)
    prompt = torch.randint(0, arch.vocab_size, (B, P), generator=gen,
                           device=device)
    runs = {}
    for tag, params, m in (("model=2", row, mesh), ("one device", whole,
                                                    None)):
        runs[tag] = drive(f"mesh qwen decode {tag}", lambda: mesh_qwen_decode(
            arch, params, device, m, prompt))
    bar, flips = flip_gaps(runs["one device"][4], runs["model=2"][4],
                           runs["one device"][5], runs["model=2"][5])
    agree = float(np.mean([bool((a == b).all()) for a, b in zip(
        torch.stack(runs["one device"][5], 1).unbind(0),
        torch.stack(runs["model=2"][5], 1).unbind(0))]))
    equal = float((torch.stack(runs["one device"][5])
                   == torch.stack(runs["model=2"][5])).float().mean())
    for tag, (pre_ms, dec_ms, ops, peak, lg, _) in runs.items():
        finite = all(bool(torch.isfinite(x).all()) for x in lg)
        print(f"[mesh qwen decode {tag}] {arch.name} at {arch.n_layers} "
              f"layers ({arch.param_dtype}, model {m0} of the bank phase "
              f"19.2 trained), B={B}: prefill of {P} tokens device ms="
              f"{pre_ms:.3f} ({B * P / pre_ms * 1e3:.1f} tokens/s), {N} "
              f"greedy decode steps device ms/token={dec_ms / N:.3f} (aten "
              f"ops/token={ops}), max_memory_allocated={peak} "
              f"({peak / 2**30:.2f} GiB), finite={finite} ({card_line})",
              flush=True)
        if not finite:
            fail(f"mesh qwen decode {tag}: non-finite logits")
    above = [f for f in flips if f[2] > bar]
    print(f"[mesh qwen flips] model=2 against one device: greedy tokens "
          f"equal={equal:.4f}, whole lanes equal={agree:.4f}; bf16 noise "
          f"bar (largest logit difference while a lane's tokens agree)="
          f"{bar}; first flips (lane, step, one device's top-2 gap)="
          f"{flips}; above the bar: {above}", flush=True)
    del whole
    # one gateway batch from the mesh bank and from the bank gathered
    one = copy.copy(tr.registry)
    one.params = bank.gathered(device)
    n, plen, new = MESH_QWEN_SERVE
    prompts = np.random.default_rng(0).integers(0, arch.vocab_size,
                                                (n, plen))
    devices = [i % FULL_LM_CLIENTS for i in range(n)]
    reqs = {}
    for tag, reg in (("model=2", tr.registry), ("one device", one)):
        gw = ServeGateway(arch, reg, lambda: tr.state, **MESH_QWEN_GW)
        out = drive(f"mesh qwen serve {tag}", lambda: serve_batch(
            gw, devices, prompts, new))
        serve_report(f"mesh qwen {tag}", gw, *out, card_line)
        reqs[tag] = out[0]
    print(f"[mesh qwen serve] tokens equal to the one-device gateway's="
          f"{agreement(reqs['model=2'], reqs['one device']):.4f}",
          flush=True)
    del one, reqs
    gc.collect()
    torch.cuda.empty_cache()


def mesh_decode_phase(device, card_line, counters, tr):
    """Phase 20 (module docstring); returns each path's launch counts,
    by path name (the decode paths on the mesh make none)."""
    import torch
    counts = {}

    def drive(tag, fn):
        for f in counters:
            f.launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts[tag] = {f.__name__: f.launches for f in counters}
        if any(counts[tag].values()):
            fail(f"{tag}: kernel launches {counts[tag]}, predicted none")
        return out

    mesh_decode_card_vs_cpu(device, drive)
    mesh_serve_card(device, drive)
    mesh_qwen_phase(device, card_line, drive, tr)
    return counts


# -- phase 21: the dry run's prediction against the card ---------------------

def dry_decode(cfg, params, toks, mesh=None, dp=("data",)):
    """Phase 21.1, one run: a prefill of DRY_DECODE's prompt and its
    decode steps; each call's logits and caches, on the host (caches
    whole)."""
    import torch

    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    B, P, N = DRY_DECODE
    prefill = steps.make_prefill_step(cfg, mesh=mesh, dp_axes=dp)
    serve = steps.make_serve_step(cfg, mesh=mesh, dp_axes=dp)
    with torch.no_grad():
        c = tf.init_lm_caches(cfg, B, P + N, device=toks.device)
        outs = [prefill(params, c, toks[:, :P], P)]
        for j in range(N):
            outs.append(serve(params, outs[-1][1], toks[:, P + j:P + j + 1]))
    return [(lg.cpu(), {k: v.cpu() for k, v in c.items()})
            for lg, c in outs]


def dry_gaps(a, b, tag):
    """Logits max_abs_err and cache max_err/scale of two dry_decode
    runs (integer cache leaves must be equal)."""
    lgap = max(float((x[0] - y[0]).abs().max()) for x, y in zip(a, b))
    cgap = max(cache_gaps(x[1], y[1], tag) for x, y in zip(a, b))
    return lgap, cgap


def dry_train(cfg, params, toks, mesh=None, dp=("data",)):
    """Phase 21.1: one train step (float32, no remat) from a copy of
    ``params``; the updated params and the loss, on the host."""
    import torch

    from repro_torch.launch import steps
    p = {k: v.clone() for k, v in params.items()}
    scores = torch.tensor([0.25, 0.75], device=toks.device)
    q, m = steps.make_train_step(cfg, mesh, dp, lr=0.05, remat=False)(
        p, toks[:, :-1], toks[:, 1:], scores)
    return {k: v.cpu() for k, v in q.items()}, float(m["loss"])


def dry_layouts(device, drive):
    """Phase 21.1 (module docstring): on cells of the card, params laid
    out by the decode_2d policy on (model=2, data=2), and the pod meshes
    of DRY_POD_MESHES (dp_axes=("pod", "data")), against the one-device
    run on the card at phase 17's bars; the pod meshes' train step
    against one device's (params MESH_PARAM_TOL; Phi's against the flat
    mesh of as many data cells, whose load-balance loss is the same mean
    over the data shards)."""
    import torch

    from repro_torch.config import override
    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch.mesh import make_launch_mesh
    from repro_torch.launch.sharding import param_shardings
    from repro_torch.launch.tensor_parallel import Sharded
    from repro_torch.models import transformer as tf
    B, P, N = DRY_DECODE
    for name in DRY_ARCHS:
        cfg = reduced(get_arch(name))
        if cfg.moe.n_experts:
            cfg = override(cfg, **{"moe.capacity_factor": 4.0})
        params = {k: v.to(device) for k, v in
                  tf.init_lm(cfg, torch.Generator().manual_seed(0)).items()}
        toks = torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab_size, (B, P + N))).to(device)
        one = drive(f"dry {name} one-device",
                    lambda: dry_decode(cfg, params, toks))
        mesh = card_mesh(device, 2, 2)
        d2 = {k: Sharded.place(params[k], mesh, v.spec) for k, v in
              param_shardings(cfg, params, mesh, "decode_2d").items()}
        got = drive(f"dry {name} decode_2d 2x2",
                    lambda: dry_decode(cfg, d2, toks, mesh))
        runs = {"decode_2d model=2,data=2": dry_gaps(got, one, name)}
        train_one = dry_train(cfg, params, toks)
        for pod, data, model in DRY_POD_MESHES:
            tag = f"pod={pod},data={data},model={model}"
            mesh = make_launch_mesh(model, data, pod=pod,
                                    devices=[device] * (pod * data * model))
            dp = ("pod", "data")
            got = drive(f"dry {name} {tag}",
                        lambda: dry_decode(cfg, params, toks, mesh, dp))
            ref = (dry_train(cfg, params, toks,
                             card_mesh(device, model, pod * data))
                   if cfg.moe.n_experts else train_one)
            q, loss = drive(f"dry {name} {tag} train",
                            lambda: dry_train(cfg, params, toks, mesh, dp))
            perr = max(float((q[k] - ref[0][k]).abs().max()) for k in q)
            runs[tag] = (*dry_gaps(got, one, name), perr,
                         abs(loss - ref[1]))
        print(f"[dry layouts {name}] {cfg.name} (float32, {cfg.n_layers} "
              f"layers), B={B}, prefill {P} + {N} decode steps against one "
              f"device (logits max_abs_err, cache max_err/scale[, train "
              f"params max_abs_err, loss diff; Phi against the flat mesh]): "
              f"{runs}", flush=True)
        for tag, gaps in runs.items():
            if not (gaps[0] <= DECODE_LOGIT_TOL and gaps[1] <= DECODE_CACHE_TOL
                    and all(g <= MESH_PARAM_TOL for g in gaps[2:])):
                fail(f"dry {name} {tag}: {gaps} beyond the bars")


def dry_step(device, arch, params, mesh, n_clients, predicted, card_line):
    """Phase 21.2, one layout: a warm step, one under CUDA events (peak
    memory from a reset), one under the port's counter; each beside the
    dry run's ``predicted`` trace of the same step. Returns the record."""
    import torch

    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.sharding import param_shardings
    from repro_torch.launch.tensor_parallel import Sharded
    from repro_torch.roofline.analysis import HW
    from repro_torch.roofline.trace_analyzer import TraceCounter
    B, S = FULL_LM_CLIENTS * FULL_LM_PER, FULL_LM_SEQ
    g = torch.Generator(device=device).manual_seed(7)
    toks = torch.randint(0, arch.vocab_size, (B, S + 1), generator=g,
                         device=device, dtype=torch.int32)
    scores = torch.rand((n_clients,), generator=g, device=device)
    if mesh is not None:
        params = {k: Sharded.place(params[k], mesh, v.spec) for k, v in
                  param_shardings(arch, params, mesh).items()}
    step = steps.make_train_step(arch, mesh)
    args = (params, toks[:, :-1], toks[:, 1:], scores)
    step(*args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _, ms = timed(lambda: step(*args))
    peak = torch.cuda.max_memory_allocated()
    counter = TraceCounter()
    counter.add_inputs(dryrun.held(args[:1], mesh))
    counter.add_inputs(dryrun.held(args[1:], mesh), batch=True)
    with counter:
        step(*args)
    torch.cuda.synchronize()
    card = counter.result(lambda t: t["flops"])
    flops = sum(c["flops"] for c in card["cells"].values())
    want = predicted["counts"]
    want_flops = sum(c["flops"] for c in want["cells"].values())
    coll = {cell: {k: v for k, v in c["collective_counts"].items() if v}
            for cell, c in card["cells"].items()}
    want_coll = {cell: {k: v for k, v in c["collective_counts"].items() if v}
                 for cell, c in want["cells"].items()}
    target = (predicted["peak_bytes_all_cells"] if mesh is not None
              else predicted["peak_bytes"])
    share = flops / (ms / 1e3) / HW().peak_flops
    rec = {"ms": ms, "flops": flops, "predicted_flops": want_flops,
           "peak": peak, "predicted_peak": target, "base": base,
           "counter_peak": (card["peak_bytes_all_cells"] if mesh is not None
                            else card["peak_bytes"]),
           "tflops": flops / (ms / 1e3) / 1e12, "share": share,
           "collectives": coll, "predicted_collectives": want_coll,
           "trace_s": predicted["trace_s"]}
    tag = "one device" if mesh is None else f"model={DRY_MODEL}"
    print(f"[dry qwen {tag}] {arch.name} at {arch.n_layers} layers "
          f"({arch.param_dtype}), B={B} S={S}, remat default: step device "
          f"ms={ms:.3f}, FLOPs card={flops:.6e} predicted={want_flops:.6e} "
          f"(equal={flops == want_flops}), {rec['tflops']:.1f} TFLOP/s = "
          f"{share:.4f} of the bf16 peak {HW().peak_flops:.3e}; "
          f"max_memory_allocated={peak} ({peak / 2**30:.2f} GiB) predicted "
          f"peak={target} ({target / 2**30:.2f} GiB, "
          f"{(target - peak) / peak:+.4f}), the counter's peak on the card="
          f"{rec['counter_peak']}, allocated when the step began={base}; "
          f"collectives by cell card={coll} "
          f"predicted={want_coll}; dry-run trace_s={predicted['trace_s']} "
          f"({card_line})", flush=True)
    if flops != want_flops or coll != want_coll:
        fail(f"dry qwen {tag}: FLOPs {flops} / collectives {coll} against "
             f"the prediction {want_flops} / {want_coll}")
    return rec


def dry_phase(device, card_line, counters):
    """Phase 21 (module docstring); returns each path's launch counts, by
    path name (none of them launches a kernel)."""
    import gc

    import torch

    from repro_torch.config import ShapeConfig, override
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as tf
    counts = {}

    def drive(tag, fn):
        for f in counters:
            f.launches = 0
        out = fn()
        torch.cuda.synchronize()
        counts[tag] = {f.__name__: f.launches for f in counters}
        if any(counts[tag].values()):
            fail(f"{tag}: kernel launches {counts[tag]}, predicted none")
        return out

    dry_layouts(device, drive)
    arch = override(get_arch(LM_ARCH), **FULL_LM_CUT)
    shape = ShapeConfig("phase14", FULL_LM_SEQ, FULL_LM_CLIENTS * FULL_LM_PER,
                        "train")
    predicted = {
        "one": dryrun.trace_case(arch, shape, None, remat=True,
                                 n_clients=FULL_LM_CLIENTS),
        "mesh": dryrun.trace_case(arch, shape,
                                  dryrun.mesh_of(f"model={DRY_MODEL}"),
                                  remat=True, n_clients=FULL_LM_CLIENTS)}
    params = tf.init_lm(arch, torch.Generator(device=device).manual_seed(0),
                        device=device)
    records = {}
    for key, mesh in (("one", None),
                      ("mesh", card_mesh(device, DRY_MODEL, 1))):
        records[key] = drive(f"dry qwen {key}", lambda: dry_step(
            device, arch, params, mesh, FULL_LM_CLIENTS, predicted[key],
            card_line))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    for key, r in records.items():
        miss = abs(r["predicted_peak"] - r["peak"]) / r["peak"]
        print(f"[dry qwen peak {key}] predicted {r['predicted_peak']} "
              f"against max_memory_allocated {r['peak']}: off by "
              f"{miss:.4f} (bar {DRY_PEAK_TOL}; PERF.md names the gap)",
              flush=True)
    return counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.conv3x3 import ops as cops
    from repro_torch.kernels.quantize import ops as qops
    from repro_torch.kernels.weighted_agg import ops as wops
    from repro_torch.models.cnn import init_cnn

    device = torch.device("cuda")
    t_script = time.perf_counter()

    def elapsed(tag):
        """The script's wall clock at the end of phase ``tag``."""
        print(f"[elapsed] phase {tag} done at "
              f"{time.perf_counter() - t_script:.1f} s", flush=True)

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
        entry = None            # every kernel and template instantiation
        for line in log.splitlines():
            found = re.search(r"Compiling entry function '([^']+)'", line)
            if found:
                entry = found.group(1)
            elif "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {entry}: {line.strip()}")

    # phase 3: kernels against their plain versions at the main path's
    # shapes (the CNN's 20 leaves) and at ragged ones
    leaves = [v.numel() for v in init_cnn(torch.Generator()).values()]
    rows = check_kernels(device, leaves)
    rows.update(check_single_kernels(device, leaves))
    for (name, m), r in rows.items():
        extra = "".join(f" {k}={r[k]}" for k in ("code_mismatches",
                                                 "scale_rel_err") if k in r)
        shape = (f"N={m}" if name in ("weighted_agg", "dequant_agg")
                 else f"M={m} B={B_PAIRS}")
        print(f"[kernel {name} {shape} leaves={len(leaves)}] "
              f"max_abs_err={r['max_abs_err']} ms={r['ms']:.5f} "
              f"eager_ms={r['eager_ms']:.5f} plain_ms={r['plain_ms']:.5f} "
              f"plain_eager_ms={r['plain_eager_ms']:.5f} "
              f"bound_ms={r['bound_ms']:.5f} ({r['bound_by']}) "
              f"library_ms={r['library_ms']}{extra}")
        if "diag" in r:
            print(f"[diag {name} {shape}] " + " ".join(
                f"{k}={v}" for k, v in r["diag"].items()))

    elapsed("1-3")
    # phase 3b: the convolution kernels at each layer of the pair step
    print_conv(*check_conv(device))

    elapsed("3b")
    # phase 4: one MLP round on the card against the CPU
    err = mlp_card_vs_cpu(device)
    print(f"[mlp card-vs-cpu] bank max_abs_err={err} val matrices equal")

    elapsed(4)
    # phase 5: the main path, with every launch counter from zero
    counters = (wops.multi_weighted_agg, wops.weighted_agg, wops.dequant_agg,
                qops.quantize, qops.dequantize)
    convs = (cops.conv3x3_fwd, cops.conv3x3_dgrad, cops.conv3x3_wgrad)
    conv_counts = {}                 # CNN path -> convolution launches
    roundtrips = count_roundtrips()

    def drive(path, tag):
        """Run the CNN path ``path`` with every launch counter from zero;
        return its result and the counts it left. The path must launch
        each convolution kernel (training and scoring both run them)."""
        for fn in counters + convs:
            fn.launches = 0
        roundtrips.calls = roundtrips.launches = 0
        out = path()
        torch.cuda.synchronize()
        counts = {fn.__name__: fn.launches for fn in counters + convs}
        conv_counts[tag] = {fn.__name__: counts[fn.__name__]
                            for fn in convs}
        print(f"[{tag} convolutions] launches={conv_counts[tag]}",
              flush=True)
        if not all(conv_counts[tag].values()):
            fail(f"{tag}: a convolution kernel was not launched "
                 f"({conv_counts[tag]})")
        return out, counts

    def report(tag, walls, launches):
        print(f"[{tag}] fedcd mean wall_s rounds 2-{SMOKE_ROUNDS}="
              f"{np.mean([w[0] for w in walls[1:]]):.4f} fedavg="
              f"{np.mean([w[1] for w in walls[1:]]):.4f} "
              f"launches={launches}")

    def check_transport_launches(tag, counts):
        # one launch of each per roundtrip call and 32 leaves of it
        print(f"[{tag} transport] roundtrip calls={roundtrips.calls} "
              f"expected launches={roundtrips.launches} each")
        if not (counts["quantize"] == counts["dequantize"]
                == roundtrips.launches > 0):
            fail(f"{tag}: quantize launched {counts['quantize']} times, "
                 f"dequantize {counts['dequantize']}, in "
                 f"{roundtrips.calls} roundtrip calls that make "
                 f"{roundtrips.launches} launches of each")

    walls_main, launches = drive(lambda: main_path(device), "main path")
    report("main path", walls_main, launches)
    for name in ("multi_weighted_agg", "quantize", "dequantize"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the main path")
    check_transport_launches("main path", launches)

    elapsed(5)
    # phase 6: the three engines agree on the card, and the pipelined and
    # sparse fused runs agree with the fused one
    err, live, stats, sparse = engines_agree(device)
    print(f"[engines] legacy == batched == fused == {' == '.join(PIPELINE_SPECS)}"
          f" over {ENGINE_ROUNDS} MLP rounds (FedCD) and legacy == batched =="
          f" fused == fused+pipeline over 4 (FedAvg): discrete state and "
          f"accuracies equal, params max_abs_err={err}, live={live}, "
          f"sparse_rounds={sparse}")
    for name, st in stats.items():
        print(f"[engines pipeline_stats] {name}: {st}")

    elapsed(6)
    # phase 7: the legacy engine at full width; then the batched engine
    walls, legacy = drive(lambda: engine_path(device, "legacy"),
                          "legacy path")
    report("legacy path", walls, legacy)
    if legacy["weighted_agg"] <= 0:
        fail("kernel weighted_agg was not launched on the legacy path")
    for name in ("quantize", "dequantize"):
        if legacy[name] <= 0:
            fail(f"kernel {name} was not launched on the legacy path")
    check_transport_launches("legacy path", legacy)
    walls, batched = drive(lambda: engine_path(device, "batched"),
                           "batched path")
    report("batched path", walls, batched)
    for name in ("multi_weighted_agg", "quantize", "dequantize"):
        if batched[name] <= 0:
            fail(f"kernel {name} was not launched on the batched path")
    check_transport_launches("batched path", batched)
    fused_counts = dict(launches)
    launches["weighted_agg"] = legacy["weighted_agg"]

    elapsed(7)
    # phase 8: the pipelined paths at full width, each with its own counts,
    # with the overlap check on the real rounds
    from repro_torch.federated.executors import (FedAvgFusedExecutor,
                                                 FusedExecutor)
    sync = {"fedcd": np.mean([w[0] for w in walls_main[1:]]),
            "fedavg": np.mean([w[1] for w in walls_main[1:]])}
    probe = OverlapProbe((FusedExecutor, FedAvgFusedExecutor))
    pipelined = {}
    consumed = 0
    try:
        for name, server, spec in PIPELINED_PATHS:
            (pwalls, drain, st), counts = drive(
                lambda: pipelined_path(device, probe, name, server, spec),
                name)
            consumed += st["hit"] + st["repaired"]
            print(f"[{name}] mean wall_s rounds 2-{SMOKE_ROUNDS}="
                  f"{np.mean(pwalls[1:]):.4f} (phase 5 sync {server} "
                  f"fused={sync[server]:.4f}) total_s="
                  f"{sum(pwalls) + drain:.4f} drain_s={drain:.4f} "
                  f"pipeline_stats={st} launches={counts}")
            # FedCD moves int8 rows (kernels 1-3); FedAvg's fused round
            # has no transport in either package (kernel 1 only)
            needed = (("multi_weighted_agg", "quantize", "dequantize")
                      if server == "fedcd" else ("multi_weighted_agg",))
            for kernel in needed:
                if counts[kernel] <= 0:
                    fail(f"kernel {kernel} was not launched on {name}")
            if server == "fedcd":
                check_transport_launches(name, counts)
            elif counts["quantize"] or counts["dequantize"] \
                    or roundtrips.calls:
                fail(f"{name}: {roundtrips.calls} transport roundtrips, "
                     f"{counts['quantize']} quantize and "
                     f"{counts['dequantize']} dequantize launches, where "
                     f"FedAvg makes none")
            pipelined[name] = counts
    finally:
        probe.remove()
    print(f"[overlap natural] readback returned while the next round's "
          f"speculative training was still running in {probe.overlapped} of "
          f"{probe.speculated} speculated rounds ({consumed} speculations "
          f"consumed; few where the host, not the card, sets the training's "
          f"pace)")

    elapsed(8)
    # phase 9: the overlap check, with a device spin after each speculation
    # so that its finding does not depend on the host's pace
    probe = OverlapProbe((FusedExecutor, FedAvgFusedExecutor),
                         hold_cycles=HOLD_CYCLES)
    try:
        consumed = overlap_check(device)
    finally:
        probe.remove()
    print(f"[overlap] readback returned while the next round's speculative "
          f"training (+ a {HOLD_CYCLES}-cycle spin) was still running in "
          f"{probe.overlapped} of {probe.speculated} speculated rounds "
          f"({consumed} speculations consumed)")
    if consumed and not probe.overlapped:
        fail("overlap: every readback waited for the speculative training")

    elapsed(9)
    # phases 10-13 run under the no-sync probe; every path has its own
    # launch counts. They hold runs to each other, and the
    # CNN's training is not run-to-run deterministic on cuDNN's default
    # convolution algorithms (phase 5 and phase 8 read different round-1
    # accuracies on one seed), so cuDNN takes deterministic ones here
    torch.backends.cudnn.deterministic = True
    print(f"[determinism] phases 10-13: torch.backends.cudnn.deterministic="
          f"{torch.backends.cudnn.deterministic}")
    nosync = NoSyncProbe()
    later = {}                       # path -> launch counts, phases 10-12

    def run_path(name, server, spec, rounds=SMOKE_ROUNDS, watch=None,
                 expect=None):
        """One counted path. ``expect``: the exact launch counts the path
        must make (phase 13), in place of 'kernel 1 launched'."""
        (srv, walls, drain), counts = drive(
            lambda: run_cell(device, name, server, spec, rounds, watch),
            name)
        later[name] = counts
        transport = (f" roundtrip calls={roundtrips.calls}"
                     if server == "fedcd" else "")
        first = rounds - len(walls) + 1        # after a resume, not 1
        print(f"[{name}] mean wall_s rounds {first + 1}-{rounds}="
              f"{np.mean(walls[1:]):.4f} total_s={sum(walls):.4f} "
              f"drain_s={drain:.4f} walls={[round(w, 4) for w in walls]}"
              f" launches={counts}{transport}", flush=True)
        if expect is not None:
            got = {k: counts[k] for k in expect}
            print(f"[{name} launches] predicted={expect} measured={got}",
                  flush=True)
            if got != expect:
                fail(f"{name}: launches {got} != predicted {expect}")
        elif counts["multi_weighted_agg"] <= 0:
            fail(f"kernel multi_weighted_agg was not launched on {name}")
        if server == "fedcd":
            check_transport_launches(name, counts)
        elif counts["quantize"] or counts["dequantize"] or roundtrips.calls:
            fail(f"{name}: FedAvg made transport launches")
        return srv, walls

    def crash_path(name, server, spec):
        """A counted run that must end in the spec's scripted crash."""
        from repro_torch.data.scenarios import SimulatedCrash

        def path():
            try:
                run_cell(device, name, server, spec)
            except SimulatedCrash as crash:
                return crash
            return None
        crash, counts = drive(path, name)
        later[name] = counts
        print(f"[{name}] {crash} launches={counts}", flush=True)
        if crash is None:
            fail(f"{name}: the scripted crash did not fire")

    clock = None
    try:
        semisync_phase(run_path, nosync)
        elapsed(10)
        churn_phase(run_path, nosync)
        elapsed(11)
        # phase 12: crash and resume at full width
        clock = CheckpointClock()
        resume_phase(run_path, crash_path, clock, device)
        elapsed(12)
        # phase 13: the sharded planes at full width
        sharded_phase(run_path, device)
        elapsed(13)
    finally:
        if clock is not None:
            clock.remove()
        nosync.remove()
        torch.backends.cudnn.deterministic = False

    # phase 14: the mode-B LM trainer (card against CPU, engines, the
    # gradient transport's kernels, Qwen3-4B at full width)
    later["lm grad transport"], qwen_full = lm_phase(device, card_line,
                                                     counters)
    elapsed(14)
    # phase 15: the MoE / MLA / MTP families (the same checks; Phi-3.5-MoE
    # and DeepSeek-V3 at their widest single-card tiers)
    later[f"lm grad transport {MOE_TRANSPORT[0]}"] = moe_phase(
        device, card_line, counters)
    elapsed(15)
    # phase 16: the Mamba2 / xLSTM / hybrid families (the same checks at
    # seq 24; xlstm-125m whole and Zamba2-7B at every published width)
    later.update(ssm_phase(device, card_line, counters))
    elapsed(16)
    # phase 17: the decode path (card against CPU on five families,
    # whisper-small whole, Qwen3-4B's prefill and decode)
    later.update(decode_phase(device, card_line, counters))
    elapsed(17)
    # phase 18: the serving plane (every gateway mode card against CPU on
    # five tiny configs; Qwen3-4B served from a trained FedCD population)
    later.update(serve_phase(device, card_line, counters))
    elapsed(18)
    # phase 19: the tensor-parallel LM mesh (the trainer on model=2 and
    # model=2,data=2 meshes against one device and the CPU, the mesh's
    # transport launches, Qwen3-4B at phase 14's tier on model=2)
    mesh_counts, mesh_tr = mesh_phase(device, card_line, counters,
                                      qwen_full)
    later.update(mesh_counts)
    elapsed(19)
    # phase 20: the decode path on the mesh (five reduced families on
    # model=2 and model=2,data=2 against one device and the CPU, the
    # gateway over a mesh-trained bank, Qwen3-4B from phase 19.2's bank)
    later.update(mesh_decode_phase(device, card_line, counters, mesh_tr))
    del mesh_tr
    elapsed(20)
    # phase 21: the dry run against the card (the decode_2d and pod
    # layouts against one device; Qwen3-4B's step beside its meta trace)
    later.update(dry_phase(device, card_line, counters))
    elapsed(21)

    # launches: kernels 1-3 on the fused main path, weighted_agg on the
    # legacy path; dequant_agg is on no path, so its count stays 0. Each
    # path's own counts are under "launches_by_path".
    meta = {
        "multi_weighted_agg": ("csrc/weighted_agg.cu",
                               "src/repro/kernels/weighted_agg/kernel.py:77",
                               M_ROWS[0]),
        "quantize": ("csrc/quantize.cu",
                     "src/repro/kernels/quantize/kernel.py:48", M_ROWS[0]),
        "dequantize": ("csrc/quantize.cu",
                       "src/repro/kernels/quantize/kernel.py:74", M_ROWS[0]),
        "weighted_agg": ("csrc/weighted_agg.cu",
                         "src/repro/kernels/weighted_agg/kernel.py:56",
                         N_DEVICES),
        "dequant_agg": ("csrc/weighted_agg.cu",
                        "src/repro/kernels/weighted_agg/kernel.py:105",
                        N_DEVICES),
    }
    kernels = []
    for name, (src, replaces, key) in meta.items():
        r = rows[(name, key)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/{src}", "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "launches_by_path": {
                "fused": fused_counts[name], "legacy": legacy[name],
                "batched": batched[name],
                **{path: counts[name] for path, counts in pipelined.items()},
                **{path: counts[name] for path, counts in later.items()}}})
    kernels[-1]["note"] = ("no path calls it, in either package; launched "
                           "only by the kernel check above")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"conv_launches_by_path": conv_counts}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
