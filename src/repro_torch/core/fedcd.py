"""FedCD server orchestration — paper Algorithm 1, mode A (port of
``repro/core/fedcd.py``, the synchronous fused engine).

One ``FedCDServer.run_round`` = one pass of Algorithm 1: sample K
devices → each trains all its active models for E epochs → score-weighted
aggregation per model (eq 1) → evaluate on validation data → update
scores (eq 2-3) → deletions (eq 4 + late rule) → milestone cloning.

The server is the CONTROL PLANE only: every round it asks a
:class:`~repro_torch.core.plan.RoundPlanner` for a host-side plan and
hands it to the :class:`~repro_torch.federated.executors.FusedExecutor`,
whose one round call trains, aggregates, quantizes and evaluates on the
server's device. Host RNG streams match the reference's: ``rng`` drives
round sampling, ``life_rng`` the clone-score noise.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.config import FedCDConfig
from repro_torch.core import quantize as qz
from repro_torch.core.lifecycle import apply_deletions, clone_at_milestone
from repro_torch.core.plan import RoundPlanner
from repro_torch.core.registry import ModelRegistry
from repro_torch.core.scores import (init_scores, normalized_scores,
                                     push_accuracies)
from repro_torch.data.bank import DeviceDataBank
from repro_torch.device import resolve_device
from repro_torch.federated.executors import FusedExecutor
from repro_torch.federated.simulation import draw_round_sample

LIFECYCLE_STREAM = 0xFEDCD   # keys the clone-noise RNG off the sampling one


def reject_unported(options: Dict[str, Any], owner: str) -> None:
    """Raise on any of the reference's engine options (spec, mesh,
    pipeline, semi-sync, sparse eval, churn, checkpoints): the port has
    only the synchronous fused engine so far."""
    if options:
        raise NotImplementedError(
            f"{owner}: {sorted(options)} not supported by the PyTorch port "
            "yet; only the synchronous fused engine is ported")


def to_device(params: Dict[str, Any], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in params.items()}


@dataclass
class RoundMetrics:
    round: int
    test_acc: np.ndarray            # (N,) best-model test accuracy per device
    val_acc: np.ndarray             # (N,)
    active_models: int              # total active (device, model) preferences
    live_models: int                # models alive on the server
    score_std: float                # mean over devices of σ(c_i) (Fig 9)
    comm_bytes: int                 # up+down transport this round (§3.6)
    wall_s: float
    preferred: np.ndarray           # (N,) argmax-score model id (Fig 7)


class FedCDServer:
    def __init__(self, cfg: FedCDConfig, init_params: Dict[str, Any],
                 loss_fn: Callable, acc_fn: Callable,
                 data: Dict[str, Any], batch_size: int = 64,
                 device: Optional[Union[str, torch.device]] = None,
                 **engine_options: Any):
        """data: stacked device splits from ``partition.stack_devices``:
        {"train": (xs (N,n,...), ys), "val": ..., "test": ...}.
        init_params: a flat param dict (tensors or arrays).

        ``device=None`` means ``"cuda"``; without a GPU this raises —
        pass ``device="cpu"`` to run on the CPU. The param bank is updated
        in place each round (the reference donates it)."""
        reject_unported(engine_options, "FedCDServer")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.life_rng = np.random.default_rng([cfg.seed, LIFECYCLE_STREAM])
        self.data = data
        self.batch_size = batch_size
        self.n_devices = data["train"][0].shape[0]
        if self.n_devices != cfg.n_devices:
            raise ValueError(f"data has {self.n_devices} devices, config "
                             f"{cfg.n_devices}")
        self.databank = DeviceDataBank(data, self.device)
        params = to_device(init_params, self.device)
        self.registry = ModelRegistry.create(params, cfg.max_models,
                                             stacked=True)
        self.state = init_scores(self.n_devices, cfg.max_models,
                                 cfg.score_window)
        self.planner = RoundPlanner(cfg)
        self.executor = FusedExecutor(cfg, self.registry, self.databank,
                                      loss_fn, acc_fn)
        self.metrics: List[RoundMetrics] = []
        self._model_bytes = sum(v.numel() * v.element_size()
                                for v in params.values())
        # depends only on leaf shapes, which all models share
        self._compressed_bytes = (
            qz.compressed_bytes(params, cfg.quantize_bits)
            if cfg.quantize_bits else self._model_bytes)
        self._prefetch: Optional[Tuple[int, Tuple[np.ndarray,
                                                  np.ndarray]]] = None

    # -- transport accounting (paper §3.6) --------------------------------
    def _transport_bytes(self, n_transfers: int) -> int:
        return n_transfers * self._compressed_bytes

    def _maybe_compress(self, params: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        return qz.roundtrip(params, self.cfg.quantize_bits)

    # -- round sampling ----------------------------------------------------
    def _draw_sample(self) -> Tuple[np.ndarray, np.ndarray]:
        return draw_round_sample(self.rng, self.n_devices,
                                 self.cfg.devices_per_round,
                                 self.data["train"][0].shape[1],
                                 self.batch_size, self.cfg.local_epochs)

    def _round_sample(self, t: int) -> Tuple[np.ndarray, np.ndarray]:
        if self._prefetch is not None and self._prefetch[0] == t:
            sample = self._prefetch[1]
            self._prefetch = None
            return sample
        return self._draw_sample()

    # -- Algorithm 1 -------------------------------------------------------
    def run_round(self, t: int) -> RoundMetrics:
        t0 = time.time()
        cfg = self.cfg
        sample = self._round_sample(t)
        c = normalized_scores(self.state)
        plan = self.planner.build(t, sample, c, self.state, self.registry,
                                  self.executor.plan_hints())
        self.executor.launch(plan)
        # overlap: draw round t+1's sample while the device works
        self._prefetch = (t + 1, self._draw_sample())
        result = self.executor.readback()

        transfers = plan.transfers
        self.state = push_accuracies(self.state, result.accs)
        self.state, _ = apply_deletions(self.state, self.registry, t, cfg)
        if t in cfg.milestones:
            self.state, cloned = clone_at_milestone(
                self.state, self.registry, t, cfg, self.life_rng,
                clone_params_fn=self._maybe_compress)
            transfers += sum(int(self.state.active[:, m2].sum())
                             for m2 in self.registry.live_ids())
            self.executor.on_clones(cloned)

        metrics = self._collect(t, transfers, time.time() - t0)
        self.metrics.append(metrics)
        return metrics

    # -- metrics -----------------------------------------------------------
    def _collect(self, t: int, transfers: int, wall: float) -> RoundMetrics:
        c = normalized_scores(self.state)
        preferred = np.argmax(np.where(self.state.active, c, -1.0), axis=1)
        test_acc, val_acc = self.executor.collect(preferred)
        stds = []
        for i in range(self.n_devices):
            ci = c[i, self.state.active[i]]
            stds.append(ci.std() if ci.size else 0.0)
        return RoundMetrics(
            round=t, test_acc=test_acc, val_acc=val_acc,
            active_models=int(self.state.active.sum()),
            live_models=len(self.registry.live_ids()),
            score_std=float(np.mean(stds)) if stds else 0.0,
            comm_bytes=self._transport_bytes(transfers),
            wall_s=wall, preferred=preferred)

    def run(self, rounds: int, log_every: int = 0) -> List[RoundMetrics]:
        for t in range(len(self.metrics) + 1, rounds + 1):
            m = self.run_round(t)
            if log_every and t % log_every == 0:
                print(f"[fedcd] round {t:3d} live={m.live_models} "
                      f"active={m.active_models} "
                      f"test_acc={m.test_acc.mean():.3f} "
                      f"score_std={m.score_std:.3f}")
        return self.metrics
