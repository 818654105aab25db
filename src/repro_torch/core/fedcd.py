"""FedCD server orchestration — paper Algorithm 1, mode A (port of
``repro/core/fedcd.py``: every mode-A engine, meshless and sharded;
pipelined, semi-synchronous and churning populations).

One ``FedCDServer.run_round`` = one pass of Algorithm 1: sample K
devices → each trains all its active models for E epochs → score-weighted
aggregation per model (eq 1) → evaluate on validation data → update
scores (eq 2-3) → deletions (eq 4 + late rule) → milestone cloning.

The server is the CONTROL PLANE only: every round it asks a
:class:`~repro_torch.core.plan.RoundPlanner` for a host-side plan and
hands it to the executor of its :class:`~repro_torch.core.spec.
EngineSpec`, which runs the round on the server's device:

* ``"fused"`` (default): params in one stacked bank, the round as one
  call (:class:`~repro_torch.federated.executors.FusedExecutor`);
* ``"batched"``: one call over the gathered pairs, then per-model
  transport (:class:`~repro_torch.federated.executors.BatchedExecutor`);
* ``"legacy"``: the per-model loop, every model trained on every device
  (:class:`~repro_torch.federated.executors.LegacyExecutor`);
* ``"sharded@S"`` / ``"sharded@SxD"`` (or an injected ``mesh``): the
  fused plane on a launch mesh — bank rows and work pairs bucket per
  owning shard or cell (:class:`~repro_torch.federated.executors.
  ShardedExecutor`, :class:`~repro_torch.federated.executors.
  Sharded2DExecutor`); ``+migrate:<x>`` moves a row off a hot shard.

On ``fused`` and ``sharded``, ``+pipeline`` splits the round into train and finish and
enqueues round t+1's training before round t's readback (cross-round
speculation), and ``+sparse:<x>`` scores only holders' validation
splits on rounds whose stale rows are sparser than ``x``; both keep the
synchronous round's results. ``+semisync`` (a straggler model) makes
rounds semi-synchronous: pairs past the quorum deadline are buffered and
folded back in, discounted, rounds later. ``scenario=`` (a
:class:`~repro_torch.data.scenarios.ChurnSchedule`) lets devices join,
leave and drift at round starts.

Elastic checkpoint/resume on every engine: ``save_every`` +
``checkpoint_dir`` snapshot the complete round state every few rounds,
``resume_from`` (a checkpoint, or a root resolving to its newest valid
step) restores it at construction, and ``faults`` (a
:class:`~repro_torch.data.scenarios.FaultSchedule`) scripts crashes at
round phases. ``save(path)`` and ``restore(path)`` do the same by hand.
Checkpoints are the reference's format (``repro_torch.checkpoint``).

Host RNG streams match the reference's on every engine: ``rng`` drives
round sampling, ``life_rng`` the clone-score noise, the schedule's own
stream the data of joining and drifting devices.
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
from repro_torch.core import quantize as qz
from repro_torch.core.lifecycle import apply_deletions, clone_at_milestone
from repro_torch.core.plan import RoundPlanner
from repro_torch.core.registry import ModelRegistry
from repro_torch.core.scores import (init_scores, normalized_scores,
                                     push_accuracies)
from repro_torch.core.spec import resolve_spec
from repro_torch.data.bank import DeviceDataBank
from repro_torch.device import resolve_device
from repro_torch.federated.executors import (BatchedExecutor, FusedExecutor,
                                             LegacyExecutor,
                                             Sharded2DExecutor,
                                             ShardedExecutor)
from repro_torch.federated.simulation import draw_round_sample
from repro_torch.launch.mesh import data_axis_size, model_axis_size
from repro_torch.launch.sharding import bank_devices, bank_rows_per_shard

# the meshless engines the port runs (tests iterate this tuple)
ENGINES = ("fused", "batched", "legacy")

LIFECYCLE_STREAM = 0xFEDCD   # keys the clone-noise RNG off the sampling one


def _server_device(device: Optional[Union[str, torch.device]],
                   mesh: Any) -> torch.device:
    """The server's home device: ``device`` (``None`` means CUDA), or on
    a launch mesh cell (0, 0)'s, where ``device``, if given, must be of
    the cells' type."""
    if mesh is None:
        return resolve_device(device)
    home = mesh.device(0, 0)
    if device is not None and torch.device(device).type != home.type:
        raise ValueError(f"device={device!r} but the launch mesh's cells "
                         f"lie on {home.type} devices: {mesh}")
    return resolve_device(home)


def to_device(params: Dict[str, Any], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """Copies of ``params`` on ``device`` (never aliases of the caller's
    tensors)."""
    return {k: torch.as_tensor(v).to(device, copy=True)
            for k, v in params.items()}


@dataclass
class RoundMetrics:
    round: int
    test_acc: np.ndarray            # (N,) best-model test accuracy per device
    val_acc: np.ndarray             # (N,)
    active_models: int              # total active (device, model) preferences
    live_models: int                # models alive on the server
    score_std: float                # mean over devices of σ(c_i) (Fig 9)
    comm_bytes: int                 # up+down transport this round (§3.6)
    wall_s: float                   # host s, round start to metrics
    preferred: np.ndarray           # (N,) argmax-score model id (Fig 7)


class FedCDServer:
    def __init__(self, cfg: FedCDConfig, init_params: Dict[str, Any],
                 loss_fn: Callable, acc_fn: Callable,
                 data: Dict[str, Any], batch_size: int = 64,
                 spec: Any = None,
                 use_agg_kernel: Optional[bool] = None,
                 engine: Optional[str] = None,
                 mesh: Any = None, pipeline: Optional[bool] = None,
                 sparse_eval: Optional[float] = None,
                 scenario: Any = None,
                 migrate_threshold: Optional[float] = None,
                 straggler: Any = None,
                 device: Optional[Union[str, torch.device]] = None):
        """data: stacked device splits from ``partition.stack_devices``:
        {"train": (xs (N,n,...), ys), "val": ..., "test": ...}.
        init_params: a flat param dict (tensors or arrays).

        ``spec``: an :class:`~repro_torch.core.spec.EngineSpec` or preset
        string (``"fused"``, ``"batched"``, ``"legacy"``, each optionally
        ``+kernel``; ``fused`` and ``sharded@S[xD]`` also with
        ``+pipeline``, ``+semisync`` and/or ``+sparse:<x>``, and an
        ``EngineSpec`` with a ``scenario``; ``sharded`` with
        ``+migrate:<x>``; the checkpoint fields on every engine). The
        other engine kwargs are the reference's deprecated spellings and
        translate through ``resolve_spec``. Invalid combinations (and
        ``engine="llm"``, the LM plane) raise ``ValueError``, here at
        construction.

        ``device=None`` means ``"cuda"``; without a GPU this raises —
        pass ``device="cpu"`` to run on the CPU. On a launch mesh the
        server's device is cell (0, 0)'s and ``device``, if given, must
        be of the cells' type; a sharded preset with ``device="cpu"``
        puts every cell on the CPU. The fused engine updates its param
        bank in place each round (the reference donates it); the legacy
        and batched engines keep a dict of params per model on the same
        device."""
        spec = resolve_spec(
            spec, dict(engine=engine, mesh=mesh, pipeline=pipeline,
                       sparse_eval=sparse_eval, scenario=scenario,
                       migrate_threshold=migrate_threshold,
                       use_agg_kernel=use_agg_kernel,
                       straggler=straggler), "FedCDServer")
        if spec.engine == "llm":
            raise ValueError(
                "engine='llm' is the mode-B LM plane — construct "
                "federated.llm.FedLLMTrainer with this spec instead")
        self.mesh = mesh = spec.resolve_mesh(device)
        self.spec = spec
        self.engine = spec.engine
        self.pipeline = spec.pipeline
        self.device = _server_device(device, mesh)
        self.migrate_threshold = spec.migrate_threshold
        self._n_shards = model_axis_size(mesh) if mesh is not None else 0
        self._rows_per_shard = (bank_rows_per_shard(cfg.max_models, mesh)
                                if mesh is not None else 0)
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.life_rng = np.random.default_rng([cfg.seed, LIFECYCLE_STREAM])
        self.data = data
        self.batch_size = batch_size
        n_initial = data["train"][0].shape[0]
        if n_initial != cfg.n_devices:
            raise ValueError(f"data has {n_initial} devices, config "
                             f"{cfg.n_devices}")
        self.scenario = scenario = spec.scenario
        # device-id space: ids are control plane and never reused, so the
        # score state sizes to every id the scenario can ever create; data
        # ROWS are bank layout and are reused. Static populations keep id
        # space == row space == N.
        self.n_devices = n_initial + (scenario.total_joins
                                      if scenario is not None else 0)
        self.present = np.zeros(self.n_devices, bool)
        self.present[:n_initial] = True
        self._churn_rng = (scenario.make_rng()
                           if scenario is not None else None)
        self.databank = DeviceDataBank(
            data, self.device,
            n_cap=(scenario.row_capacity(n_initial)
                   if scenario is not None else None),
            id_cap=self.n_devices, mesh=mesh)
        params = to_device(init_params, self.device)
        # only the fused engine stacks its params into one bank, split
        # over the model shards of a launch mesh
        self.registry = ModelRegistry.create(
            params, cfg.max_models, stacked=(self.engine == "fused"),
            n_shards=max(self._n_shards, 1),
            devices=bank_devices(mesh) if mesh is not None else None)
        self.state = init_scores(self.n_devices, cfg.max_models,
                                 cfg.score_window)
        # ids beyond the initial population haven't joined yet
        self.state.active[n_initial:, :] = False
        self.planner = RoundPlanner(cfg, sparse_eval=spec.sparse_eval,
                                    straggler=spec.straggler,
                                    n_devices=self.n_devices)
        self.executor = self._make_executor(loss_fn, acc_fn)
        self.metrics: List[RoundMetrics] = []
        self._telemetry_id = telemetry.new_id()
        self._model_bytes = sum(v.numel() * v.element_size()
                                for v in params.values())
        # depends only on leaf shapes, which all models share
        self._compressed_bytes = (
            qz.compressed_bytes(params, cfg.quantize_bits)
            if cfg.quantize_bits else self._model_bytes)
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

    def _make_executor(self, loss_fn: Callable, acc_fn: Callable):
        if self.engine == "fused":
            if self.mesh is not None:
                cls = (Sharded2DExecutor if data_axis_size(self.mesh) > 1
                       else ShardedExecutor)
                return cls(self.cfg, self.registry, self.databank, loss_fn,
                           acc_fn, self.mesh, pipeline=self.pipeline,
                           migrate_threshold=self.migrate_threshold)
            return FusedExecutor(self.cfg, self.registry, self.databank,
                                 loss_fn, acc_fn, pipeline=self.pipeline)
        cls = (BatchedExecutor if self.engine == "batched"
               else LegacyExecutor)
        return cls(self.cfg, self.registry, self.databank, loss_fn, acc_fn,
                   self.batch_size)

    @property
    def pipeline_stats(self):
        """Speculation accounting (pipelined executors; None otherwise)."""
        return self.executor.stats

    @property
    def semisync_stats(self):
        """Semi-synchronous round accounting
        (:class:`~repro_torch.core.plan.SemiSyncStats`; None when the spec
        has no straggler model)."""
        coord = self.planner.semisync
        return coord.stats if coord is not None else None

    # -- transport accounting (paper §3.6) --------------------------------
    def _transport_bytes(self, n_transfers: int) -> int:
        return n_transfers * self._compressed_bytes

    def _maybe_compress(self, params: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        return qz.roundtrip(params, self.cfg.quantize_bits)

    # -- round sampling ----------------------------------------------------
    def _draw_sample(self, present: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """One round's participation mask + minibatch perms. ``present``
        overrides the current presence mask (the prefetch passes the NEXT
        round's post-churn population, computable because the schedule
        is scripted)."""
        return draw_round_sample(self.rng, self.n_devices,
                                 self.cfg.devices_per_round,
                                 self.data["train"][0].shape[1],
                                 self.batch_size, self.cfg.local_epochs,
                                 present=(self.present if present is None
                                          else present))

    def _round_sample(self, t: int) -> Tuple[np.ndarray, np.ndarray]:
        if self._prefetch is not None and self._prefetch[0] == t:
            sample = self._prefetch[1]
            self._prefetch = None
            return sample
        return self._draw_sample()

    # -- device churn ------------------------------------------------------
    def _present_after(self, t: int) -> np.ndarray:
        """The presence mask once round ``t``'s scheduled churn applies,
        WITHOUT applying it (joins claim sequential ids)."""
        mask = self.present.copy()
        if self.scenario is None or not self.scenario.has_events(t):
            return mask
        for e in self.scenario.leaves_at(t):
            mask[e.device] = False
        nid = self.databank.next_id
        for _ in self.scenario.joins_at(t):
            mask[nid] = True
            nid += 1
        return mask

    def _apply_churn(self, t: int) -> Tuple[List[int], List[int]]:
        """Resolve round ``t``'s device-lifecycle intents at round start
        (leaves → joins → drifts). A joining device activates every live
        model with an empty score window (raw score 1.0 — the paper's
        init); a leaving device's preferences clear and its data-bank
        slot frees for reuse; a drifting device's splits rewrite in place
        and its score window resets (its history scored the OLD
        distribution)."""
        if self.scenario is None or not self.scenario.has_events(t):
            return [], []
        joined: List[int] = []
        left: List[int] = []
        drifted: List[int] = []
        for e in self.scenario.leaves_at(t):
            d = e.device
            self.present[d] = False
            self.state.active[d, :] = False
            self.state.history[d] = np.nan
            self.databank.remove(d)
            left.append(d)
        for e in self.scenario.joins_at(t):
            dev = self.scenario.make_device(self._churn_rng, e.archetype)
            d = self.databank.add(dev)
            self.present[d] = True
            for m in self.registry.live_ids():
                self.state.active[d, m] = True
            joined.append(d)
        for e in self.scenario.drifts_at(t):
            self.databank.update(
                e.device,
                self.scenario.make_device(self._churn_rng, e.archetype))
            self.state.history[e.device] = np.nan
            drifted.append(e.device)
        self.executor.on_churn(joined, left, drifted)
        return joined, left

    # -- elastic checkpoint/resume -----------------------------------------
    def _fault(self, t: int, phase: str) -> None:
        """Fault-injection hook: raise SimulatedCrash when the spec's
        FaultSchedule scripts a crash at (round, phase)."""
        if self._faults is not None:
            self._faults.check(t, phase)

    def save(self, path: str) -> str:
        """Snapshot the complete logical round state (between rounds)."""
        return save_server_state(self, path)

    def restore(self, path: str) -> int:
        """Restore from a checkpoint directory (or a checkpoint root,
        resolving to its latest valid step). Returns the last completed
        round; ``run`` continues from the next one."""
        resolved = latest_checkpoint(path)
        if resolved is None:
            raise CheckpointError(f"no valid checkpoint under {path!r}")
        return restore_server_state(self, resolved)

    # -- Algorithm 1 -------------------------------------------------------
    def run_round(self, t: int) -> RoundMetrics:
        with telemetry.Round("fedcd", self._telemetry_id, t,
                             self.executor.stats) as rnd:
            return self._round(t, rnd)

    def _round(self, t: int, rnd: telemetry.Round) -> RoundMetrics:
        cfg = self.cfg
        joined, left = self._apply_churn(t)
        with telemetry.span("plan"):
            sample = self._round_sample(t)
            c = normalized_scores(self.state)
            churn_next = (self.scenario is not None
                          and self.scenario.has_events(t + 1))
            plan = self.planner.build(t, sample, c, self.state,
                                      self.registry,
                                      self.executor.plan_hints(),
                                      churn=(joined, left),
                                      churn_next=churn_next)
        self._fault(t, "post-plan")
        with telemetry.span("launch"):
            self.executor.launch(plan)
        # overlap: draw round t+1's sample while the device works
        self._prefetch = (t + 1,
                          self._draw_sample(self._present_after(t + 1)))
        if self.pipeline:
            # cross-round speculation: enqueue round t+1's training from
            # the prefetched sample + pre-lifecycle state
            with telemetry.span("speculate"):
                spec = self.planner.build_speculative(
                    t + 1, self._prefetch[1], self.state, self.registry)
                self.executor.speculate(spec)
        self._fault(t, "mid-dispatch")
        with telemetry.span("readback"):
            result = self.executor.readback()

        transfers = plan.transfers
        with telemetry.span("lifecycle"):
            self.state = push_accuracies(self.state, result.accs)
            self.state, _ = apply_deletions(self.state, self.registry, t,
                                            cfg)
            if t in cfg.milestones:
                self.state, cloned = clone_at_milestone(
                    self.state, self.registry, t, cfg, self.life_rng,
                    clone_params_fn=self._maybe_compress)
                transfers += sum(int(self.state.active[:, m2].sum())
                                 for m2 in self.registry.live_ids())
                self.executor.on_clones(cloned)
                self.planner.on_clones(cloned)   # clones inherit fold mass

        with telemetry.span("collect"):
            metrics = self._collect(t, transfers)
        metrics.wall_s = rnd.elapsed_s()
        telemetry.count("comm_bytes", metrics.comm_bytes)
        self.metrics.append(metrics)
        self._fault(t, "post-readback")
        if self._ckpt is not None:
            self._ckpt.maybe_save(self, t)
        return metrics

    # -- metrics -----------------------------------------------------------
    def _collect(self, t: int, transfers: int) -> RoundMetrics:
        """The round's metrics; ``_round`` sets ``wall_s``."""
        c = normalized_scores(self.state)
        preferred = np.argmax(np.where(self.state.active, c, -1.0), axis=1)
        test_acc, val_acc = self.executor.collect(preferred)
        stds = []
        for i in np.nonzero(self.present)[0]:
            ci = c[i, self.state.active[i]]
            stds.append(ci.std() if ci.size else 0.0)
        return RoundMetrics(
            round=t, test_acc=test_acc, val_acc=val_acc,
            active_models=int(self.state.active.sum()),
            live_models=len(self.registry.live_ids()),
            score_std=float(np.mean(stds)) if stds else 0.0,
            comm_bytes=self._transport_bytes(transfers),
            wall_s=0.0, preferred=preferred)

    def run(self, rounds: int, log_every: int = 0) -> List[RoundMetrics]:
        # a resumed server continues from the round after its checkpoint
        for t in range(len(self.metrics) + 1, rounds + 1):
            m = self.run_round(t)
            if log_every and t % log_every == 0:
                print(f"[fedcd] round {t:3d} live={m.live_models} "
                      f"active={m.active_models} "
                      f"test_acc={m.test_acc.mean():.3f} "
                      f"score_std={m.score_std:.3f}")
        return self.metrics
