"""FedAvg baseline (McMahan et al. 2017), the paper's comparison system
(port of ``repro/core/fedavg.py``).

Identical client loop and data plumbing as FedCDServer so the comparison
isolates the algorithm: one global model, uniform averaging over the
participating devices' updates. Engines mirror FedCDServer: ``"fused"``
(default) keeps the global model as row 0 of a device bank and runs the
round as one call; ``"batched"`` / ``"legacy"`` keep it as a param dict
on the device. On a launch mesh (``"sharded@S"``) the work-PAIR axis
shards over the ``model`` axis (partial sums, one sum over the shards);
``"sharded@SxD"`` also shards the device data over ``data``.
``"fused+pipeline"`` splits train and finish and
enqueues round t+1's training (its sample prefetched) before round t's
readback. ``+semisync`` makes rounds semi-synchronous through the same
coordinator as FedCD's planner (one model, id 0). It draws the same
sampling stream as FedCDServer, in the same order with or without the
pipeline, so FedCD-vs-FedAvg comparisons see identical cohorts.
Checkpoints, resume and scripted crashes work as in FedCDServer.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.checkpoint.io import CheckpointError
from repro_torch.checkpoint.state import (CheckpointManager,
                                          latest_checkpoint,
                                          restore_server_state,
                                          save_server_state)
from repro_torch.config import FedCDConfig
from repro_torch.core.fedcd import _server_device, to_device
from repro_torch.core.plan import RoundPlan, SemiSyncCoordinator
from repro_torch.core.spec import resolve_spec
from repro_torch.data.bank import DeviceDataBank
from repro_torch.federated.executors import (FedAvgFusedExecutor,
                                             FedAvgHostExecutor,
                                             FedAvgSharded2DExecutor,
                                             FedAvgShardedExecutor)
from repro_torch.federated.simulation import draw_round_sample
from repro_torch.launch.mesh import data_axis_size


@dataclass
class FedAvgRound:
    round: int
    test_acc: np.ndarray
    val_acc: np.ndarray
    comm_bytes: int
    wall_s: float                        # host s, round start to metrics


class FedAvgServer:
    def __init__(self, cfg: FedCDConfig, init_params: Dict[str, Any],
                 loss_fn: Callable, acc_fn: Callable,
                 data: Dict[str, Any], batch_size: int = 64,
                 spec: Any = None, engine: Optional[str] = None,
                 mesh: Any = None, pipeline: Optional[bool] = None,
                 straggler: Any = None,
                 device: Optional[Union[str, torch.device]] = None):
        """``spec``: an :class:`~repro_torch.core.spec.EngineSpec` or
        preset string — ``"fused"`` or ``"sharded@S[xD]"`` (optionally
        ``+pipeline`` and/or ``+semisync``; or an injected ``mesh``),
        ``"batched"`` or ``"legacy"``, each with the checkpoint fields.
        ``engine="llm"`` and the FedCD-only capabilities (``scenario``,
        ``sparse_eval``, ``migrate_threshold``, ``use_agg_kernel``) raise
        ``ValueError`` as in the reference. ``engine=``/``mesh=``/
        ``pipeline=``/``straggler=`` are the deprecated spellings.

        ``device=None`` means ``"cuda"``; without a GPU this raises —
        pass ``device="cpu"`` to run on the CPU (a sharded preset then
        puts every cell on the CPU; on a mesh the server's device is
        cell (0, 0)'s). The fused engine updates the global model in
        place each round."""
        spec = resolve_spec(
            spec, dict(engine=engine, mesh=mesh, pipeline=pipeline,
                       straggler=straggler), "FedAvgServer")
        if spec.engine == "llm":
            raise ValueError(
                "engine='llm' is the mode-B LM plane — construct "
                "federated.llm.FedLLMTrainer with this spec instead")
        for name, on in (("scenario churn", spec.scenario is not None),
                         ("sparse_eval", spec.sparse_eval is not None),
                         ("migrate_threshold",
                          spec.migrate_threshold is not None),
                         ("use_agg_kernel", spec.use_agg_kernel)):
            if on:
                raise ValueError(
                    f"FedAvgServer does not support {name} (FedCD only)")
        self.mesh = mesh = spec.resolve_mesh(device)
        self.spec = spec
        self.engine = spec.engine
        self.pipeline = spec.pipeline
        self.device = _server_device(device, mesh)
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.data = data
        self.batch_size = batch_size
        self.n_devices = data["train"][0].shape[0]
        params = to_device(init_params, self.device)
        databank = DeviceDataBank(data, self.device, mesh=mesh)
        if self.engine == "fused" and mesh is not None:
            cls = (FedAvgSharded2DExecutor if data_axis_size(mesh) > 1
                   else FedAvgShardedExecutor)
            self.executor = cls(cfg, databank, params, loss_fn, acc_fn,
                                mesh, pipeline=self.pipeline)
        elif self.engine == "fused":
            self.executor = FedAvgFusedExecutor(cfg, databank, params,
                                                loss_fn, acc_fn,
                                                pipeline=self.pipeline)
        else:
            self.executor = FedAvgHostExecutor(
                cfg, databank, params, loss_fn, acc_fn, batch_size,
                batched=(self.engine == "batched"))
        self.semisync = (SemiSyncCoordinator(spec.straggler,
                                             self.n_devices)
                         if spec.straggler is not None else None)
        self.metrics: List[FedAvgRound] = []
        self._telemetry_id = telemetry.new_id()
        self._model_bytes = sum(v.numel() * v.element_size()
                                for v in params.values())
        self._prefetch: Optional[Tuple[int, Tuple[np.ndarray,
                                                  np.ndarray]]] = None
        # elastic checkpoint/resume + fault injection
        self._faults = spec.faults
        self._ckpt = (CheckpointManager(spec.checkpoint_dir,
                                        spec.save_every,
                                        faults=spec.faults)
                      if spec.checkpoint_dir else None)
        if spec.resume_from:
            path = latest_checkpoint(spec.resume_from)
            if path is None:
                raise CheckpointError(
                    f"resume_from={spec.resume_from!r}: no valid "
                    "checkpoint found (torn/corrupt steps are skipped)")
            restore_server_state(self, path)

    @property
    def pipeline_stats(self):
        """Speculation accounting (pipelined executors; None otherwise)."""
        return self.executor.stats

    @property
    def semisync_stats(self):
        """Semi-synchronous round accounting
        (:class:`~repro_torch.core.plan.SemiSyncStats`; None when the spec
        has no straggler model)."""
        return self.semisync.stats if self.semisync is not None else None

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

    def _draw_sample(self) -> Tuple[np.ndarray, np.ndarray]:
        return draw_round_sample(
            self.rng, self.n_devices, self.cfg.devices_per_round,
            self.data["train"][0].shape[1], self.batch_size,
            self.cfg.local_epochs)

    # -- elastic checkpoint/resume -----------------------------------------
    def _fault(self, t: int, phase: str) -> None:
        if self._faults is not None:
            self._faults.check(t, phase)

    def save(self, path: str) -> str:
        """Snapshot the complete logical round state (between rounds)."""
        return save_server_state(self, path)

    def restore(self, path: str) -> int:
        """Restore from a checkpoint directory (or root — resolves to its
        latest valid step); returns the last completed round."""
        resolved = latest_checkpoint(path)
        if resolved is None:
            raise CheckpointError(f"no valid checkpoint under {path!r}")
        return restore_server_state(self, resolved)

    def run_round(self, t: int) -> FedAvgRound:
        with telemetry.Round("fedavg", self._telemetry_id, t,
                             self.executor.stats) as rnd:
            return self._round(t, rnd)

    def _round(self, t: int, rnd: telemetry.Round) -> FedAvgRound:
        with telemetry.span("plan"):
            if self._prefetch is not None and self._prefetch[0] == t:
                participating, perms = self._prefetch[1]
                self._prefetch = None
            else:
                participating, perms = self._draw_sample()
            plan = self._plan(t, participating, perms)
            if self.semisync is not None:
                self.semisync.resolve(plan, live=[0])
        self._fault(t, "post-plan")
        with telemetry.span("launch"):
            self.executor.launch(plan)
        if self.pipeline:
            # FedAvg's next round depends on nothing this round computes:
            # prefetch the sample and enqueue its training now
            with telemetry.span("speculate"):
                self._prefetch = (t + 1, self._draw_sample())
                self.executor.speculate(
                    self._plan(t + 1, *self._prefetch[1]))
        self._fault(t, "mid-dispatch")
        with telemetry.span("readback"):
            result = self.executor.readback()
        m = FedAvgRound(
            round=t, test_acc=result.test_acc, val_acc=result.val_acc,
            comm_bytes=2 * int(participating.sum()) * self._model_bytes,
            wall_s=rnd.elapsed_s())
        telemetry.count("comm_bytes", m.comm_bytes)
        self.metrics.append(m)
        self._fault(t, "post-readback")
        if self._ckpt is not None:
            self._ckpt.maybe_save(self, t)
        return m

    def run(self, rounds: int, log_every: int = 0) -> List[FedAvgRound]:
        # a resumed server continues from the round after its checkpoint
        for t in range(len(self.metrics) + 1, rounds + 1):
            m = self.run_round(t)
            if log_every and t % log_every == 0:
                print(f"[fedavg] round {t:3d} "
                      f"test_acc={m.test_acc.mean():.3f}")
        return self.metrics
