"""FedAvg baseline (McMahan et al. 2017), the paper's comparison system
(port of ``repro/core/fedavg.py``, the synchronous fused engine).

Identical client loop and data plumbing as FedCDServer so the comparison
isolates the algorithm: one global model, uniform averaging over the
participating devices' updates. It draws the same sampling stream as
FedCDServer, so FedCD-vs-FedAvg comparisons see identical cohorts.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.config import FedCDConfig
from repro_torch.core.fedcd import reject_unported, to_device
from repro_torch.core.plan import RoundPlan
from repro_torch.data.bank import DeviceDataBank
from repro_torch.device import resolve_device
from repro_torch.federated.executors import FedAvgFusedExecutor
from repro_torch.federated.simulation import draw_round_sample


@dataclass
class FedAvgRound:
    round: int
    test_acc: np.ndarray
    val_acc: np.ndarray
    comm_bytes: int
    wall_s: float


class FedAvgServer:
    def __init__(self, cfg: FedCDConfig, init_params: Dict[str, Any],
                 loss_fn: Callable, acc_fn: Callable,
                 data: Dict[str, Any], batch_size: int = 64,
                 device: Optional[Union[str, torch.device]] = None,
                 **engine_options: Any):
        """``device=None`` means ``"cuda"``; without a GPU this raises —
        pass ``device="cpu"`` to run on the CPU. The global model is
        updated in place each round."""
        reject_unported(engine_options, "FedAvgServer")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.data = data
        self.batch_size = batch_size
        self.n_devices = data["train"][0].shape[0]
        params = to_device(init_params, self.device)
        self.executor = FedAvgFusedExecutor(
            cfg, DeviceDataBank(data, self.device), params, loss_fn, acc_fn)
        self.metrics: List[FedAvgRound] = []
        self._model_bytes = sum(v.numel() * v.element_size()
                                for v in params.values())

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The global model (row 0 of the device bank)."""
        return self.executor.get_params()

    @params.setter
    def params(self, value: Dict[str, Any]) -> None:
        self.executor.set_params(value)

    def _plan(self, t: int, participating: np.ndarray,
              perms: np.ndarray) -> RoundPlan:
        """FedAvg's one-model work order: every participating device is a
        (model 0, device) pair with uniform weight."""
        d_ids = [int(d) for d in np.nonzero(participating)[0]]
        return RoundPlan(
            round=t, participating=participating, perms=perms,
            scores=np.ones((self.n_devices, 1), np.float32), live=[0],
            agg_models=[0], pair_model=[0] * len(d_ids),
            pair_device=d_ids, transfers=2 * len(d_ids),
            val_stale=[0], test_stale=[0])

    def run_round(self, t: int) -> FedAvgRound:
        t0 = time.time()
        cfg = self.cfg
        participating, perms = draw_round_sample(
            self.rng, self.n_devices, cfg.devices_per_round,
            self.data["train"][0].shape[1], self.batch_size,
            cfg.local_epochs)
        self.executor.launch(self._plan(t, participating, perms))
        result = self.executor.readback()
        m = FedAvgRound(
            round=t, test_acc=result.test_acc, val_acc=result.val_acc,
            comm_bytes=2 * int(participating.sum()) * self._model_bytes,
            wall_s=time.time() - t0)
        self.metrics.append(m)
        return m

    def run(self, rounds: int, log_every: int = 0) -> List[FedAvgRound]:
        for t in range(len(self.metrics) + 1, rounds + 1):
            m = self.run_round(t)
            if log_every and t % log_every == 0:
                print(f"[fedavg] round {t:3d} "
                      f"test_acc={m.test_acc.mean():.3f}")
        return self.metrics
