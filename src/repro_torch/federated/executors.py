"""Device-side round executors: the data-plane half of a federated round
(port of ``repro/federated/executors.py``: the mode-A executors —
legacy, batched, fused and mesh-sharded; synchronous, pipelined and
semi-synchronous rounds, and device churn on the fused and sharded
ones — and the mode-B LM executors, ``LLMLegacyExecutor`` and
``FedLLMExecutor``).

A :class:`RoundExecutor` turns one host-built
:class:`~repro_torch.core.plan.RoundPlan` into device work. The contract:

    plan_hints()  -> what the executor can reuse bit-identically
    launch(plan)  -> enqueue the round's device work
    speculate(p)  -> optionally enqueue round t+1's TRAINING from a
                     speculative plan (pipelined executors only)
    readback()    -> wait for the eval matrices, return RoundResult
    collect(pref) -> the round's preferred-model test/val accuracies
    quiesce()     -> the checkpoint barrier: drop in-flight speculation

**Pipelined execution** (``pipeline=True`` on the fused executors):
training is a pure read of the parameter bank (``make_pair_train``), so
round t+1's training is enqueued, from the prefetched sample and the
pre-lifecycle population, before round t's eval matrices are read back.
The device then trains while the host reads back, runs the lifecycle
and plans. At the next ``launch`` the speculation is *repaired*
(deletions only shrink the pair set: dead pairs keep zero aggregation
weight, dead rows drop out of the scatter) or *invalidated and
retrained* (clones wrote bank rows or added pairs, seen through the
bank's ``version`` and a pair-subset check). Aggregation weights,
scatter rows and eval schedules are never speculative: they come from
the TRUE plan at launch, which is why repair is exact.

**Readback without synchronisation.** Every eval matrix is copied to
the host as soon as it is enqueued, before any speculation: into pinned
memory, non-blocking, with an event recorded after the copy. A reader
waits on that event alone, so round t+1's training, enqueued after it,
keeps running while the host works (a ``.cpu()`` would wait for it).

**Semi-synchronous rounds** (a plan with straggler or dropped pairs):
straggler pairs still train; their trained rows are copied out of the
batch on the card at launch, before any speculation (``_harvest_rows``),
and keyed (dispatch round, model, device) into the executor's carry-over
buffer. When the planner says a buffered update has arrived, the next
launch blends it into its model's bank row on the card
(``_blend_stale``), before that round's dispatch. Neither ever copies to
the host.

**Device churn**: plans name devices by id; the data bank's ``row_of``
resolves data rows at dispatch (``_drows``) and eval-matrix columns map
back to ids (``_to_id_row``); plans name models by id too, and the param
bank's ``row_of`` places them (``_rows``).

**Meshes**: the sharded executors override only bucketing, the
aggregation schedule and the eval dispatch (``_dispatch_train``,
``_dispatch_apply``, ``_finish_round``, ``_dispatch_dense``,
``_dispatch_sparse_val``, ``_note_load``, ``eval_rows``); launch,
speculation, repair, harvest, fold, readback and the eval-row caches
are the fused executor's. A trained batch on a mesh is a list of
per-cell blocks, addressed through ``TrainMeta.positions``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.config import FedCDConfig
from repro_torch.core import quantize as qz
from repro_torch.core.aggregate import (multi_weighted_average,
                                        weighted_average)
from repro_torch.core.plan import EvalHints, RoundPlan
from repro_torch.core.registry import ModelRegistry
from repro_torch.data.bank import DeviceDataBank
from repro_torch.federated.simulation import (
    bucket_size, make_eval, make_fused_apply, make_fused_eval,
    make_fused_finish, make_group_eval, make_local_train, make_pair_eval,
    make_pair_train, make_sharded2d_apply, make_sharded_apply,
    make_sharded_eval, make_sharded_fedavg_eval, make_sharded_fedavg_finish,
    make_llm_eval, make_llm_round, make_sharded_finish,
    make_sharded_pair_eval, make_sharded_train, pad_live_rows, pad_work_batch, shard_eval_pairs, shard_eval_pairs_2d,
    shard_pairs_2d, shard_rows, shard_work_batch, to_device)
from repro_torch.launch.mesh import (LaunchMesh, data_axis_size,
                                     model_axis_size)
from repro_torch.launch.sharding import Replicas, bank_rows_per_shard
from repro_torch.launch.tensor_parallel import Sharded
from repro_torch.models.common import Params


@dataclass
class RoundResult:
    """What the control plane needs back from one dispatched round."""
    accs: np.ndarray                     # (N, M_cap) val accuracies


@dataclass
class PipelineStats:
    """Cross-round speculation accounting."""
    speculated: int = 0                  # train dispatches pre-launched
    hit: int = 0                         # consumed unchanged
    repaired: int = 0                    # consumed after deletions
    invalidated: int = 0                 # stale at launch (clone writes /
    #                                      pairs outside the batch)
    discarded: int = 0                   # never consumed (extinction /
    #                                      no-pair round)
    skipped: int = 0                     # not speculated (milestone intent)

    def as_dict(self) -> Dict[str, int]:
        return {"speculated": self.speculated, "hit": self.hit,
                "repaired": self.repaired,
                "invalidated": self.invalidated,
                "discarded": self.discarded, "skipped": self.skipped}


@dataclass
class TrainMeta:
    """Which (model, device) pairs a train batch covers, in bucket-column
    order (the repair contract: aggregation weights are addressed by
    these columns, so a superset batch aggregates identically once dead
    pairs get zero weight); ``b_pad`` is the padded batch width (per
    cell on a mesh). ``positions[k]`` is pair k's row in the trained
    batch (the identity when None); on a mesh the batch is a list of
    per-cell blocks and row ``p`` is row ``p % b_pad`` of block
    ``p // b_pad``. ``pair_groups`` (a mesh's bucketing) lists each
    cell's pairs in bucket-column order."""
    pair_model: List[int]
    pair_device: List[int]
    b_pad: int
    pair_groups: Optional[List[List[int]]] = None
    positions: Optional[List[int]] = None


def _group_positions(groups: List[List[int]], width: int,
                     n_pairs: int) -> List[int]:
    """Pair k's trained-batch row under a grouped bucketing: group g's
    j-th member sits at ``g * width + j``."""
    pos = [0] * n_pairs
    for g, members in enumerate(groups):
        for j, k in enumerate(members):
            pos[k] = g * width + j
    return pos


def _host(t: torch.Tensor) -> np.ndarray:
    """A blocking read of ``t`` (a ``wait`` span)."""
    with telemetry.wait():
        return t.detach().cpu().numpy()


def _host_async(t: torch.Tensor) -> Callable[[], np.ndarray]:
    """Start copying ``t`` to the host and return the reader that waits
    for that copy alone (a ``wait`` span). On the card: a non-blocking
    copy into pinned memory and an event recorded after it, which the
    reader waits on (not the stream, so later work does not delay it).
    On the CPU a plain copy, made now."""
    if t.device.type != "cuda":
        host = t.detach().cpu().numpy()

        def read_now() -> np.ndarray:
            with telemetry.wait():
                return host
        return read_now
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t.detach(), non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))

    def read() -> np.ndarray:
        with telemetry.wait():
            done.synchronize()
        return out.numpy()
    return read


def _note_train(pairs: int, rows: int, width: int) -> None:
    """Count one train dispatch: ``pairs`` useful pairs in ``rows``
    trained rows (buckets of ``width``)."""
    telemetry.count("pairs", pairs)
    telemetry.count("pairs_padded", rows - pairs)
    telemetry.new_train_width(width)


def _stack(trees: List[Params]) -> Params:
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


StaleKey = Tuple[int, int, int]          # (dispatch round, model, device)


def _harvest_rows(stale_updates: Dict[StaleKey, Params], plan: RoundPlan,
                  trained: "Params | List[Optional[Params]]",
                  meta: TrainMeta) -> None:
    """Copy the straggler pairs' trained rows out of the batch into the
    carry-over buffer keyed (dispatch round, model, device): one gather
    per leaf (per cell block on a mesh) into new tensors, on the batch's
    device and stream, so the rows never reach the host and no later
    write to the batch can touch them. Addressed by (model, device)
    through META's positions — on a repaired speculation the batch is a
    superset in its own column order, so plan indices must not be used
    directly."""
    pos = meta.positions or range(len(meta.pair_model))
    pos_of = {p: pos[k] for k, p in enumerate(zip(meta.pair_model,
                                                  meta.pair_device))}
    picks: Dict[int, List[Tuple[StaleKey, int]]] = {}
    for k in plan.straggler_pairs:
        m, d = plan.pair_model[k], plan.pair_device[k]
        p = pos_of.get((m, d))
        if p is None:
            continue
        if isinstance(trained, list):
            cell, row = divmod(p, meta.b_pad)
        else:
            cell, row = 0, p
        picks.setdefault(cell, []).append(((plan.round, m, d), row))
    for cell, items in picks.items():
        block = trained[cell] if isinstance(trained, list) else trained
        idx = to_device(np.asarray([r for _, r in items]), np.int64,
                        next(iter(block.values())).device)
        rows = {name: v.index_select(0, idx) for name, v in block.items()}
        for j, (key, _) in enumerate(items):
            stale_updates[key] = {name: v[j] for name, v in rows.items()}


def _matured(stale_updates: Dict[StaleKey, Params], plan: RoundPlan
             ) -> List[Tuple[int, float, List[Tuple[float, Params]]]]:
    """Take the plan's fold orders out of the carry-over buffer: drop the
    expired keys, and return (model, prior mass, [(weight, row), ...])
    for each model with a buffered update to fold."""
    for key in plan.fold_drops:
        stale_updates.pop(key, None)
    out = []
    for m, (mass, entries) in plan.folds.items():
        updates = []
        for e in entries:
            key = (e.dispatch_round, m, e.device)
            if key in stale_updates:
                updates.append((e.weight, stale_updates.pop(key)))
        if updates:
            out.append((m, mass, updates))
    return out


def _blend_stale(current: Params, mass: float,
                 updates: List[Tuple[float, Params]]) -> Params:
    """The eq-1 fold: blend staleness-discounted stale updates into a
    model's params as a mass-weighted average,
    ``(M·w + Σ c̃_j·v_j) / (M + Σ c̃_j)``. With M = 0 (a model that never
    aggregated) this is the plain eq-1 average of the late arrivals.
    The reference's float32 operation order, one rounding per step:
    ``acc = w·M``, then ``acc = acc + c̃_j·v_j`` per update, then
    ``acc / total``. Every coefficient is a float32 tensor (one pinned
    copy to the device), so the division is IEEE division, never a
    multiply by a reciprocal, and the same on the CPU and the card.
    Updates harvested on another cell's device move to the model's."""
    total = mass + sum(w for w, _ in updates)
    cur0 = next(iter(current.values()))
    coef = to_device(np.array([mass] + [w for w, _ in updates] + [total],
                              np.float32), np.float32, cur0.device)
    out: Params = {}
    for k, cur in current.items():
        acc = cur.float() * coef[0]
        for j, (_, tree) in enumerate(updates, 1):
            acc = acc + coef[j] * tree[k].to(cur.device).float()
        out[k] = (acc / coef[-1]).to(cur.dtype)
    return out


class RoundExecutor:
    """Shared scaffolding; engines override the dispatch internals."""

    stats: Optional[PipelineStats] = None    # pipelined executors only

    def __init__(self, cfg: FedCDConfig, registry: ModelRegistry,
                 databank: DeviceDataBank):
        self.cfg = cfg
        self.registry = registry
        self.databank = databank
        self.n_devices = databank.id_cap
        self._result: Optional[RoundResult] = None

    @property
    def _dev(self) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        return self.databank.splits

    def plan_hints(self) -> Optional[EvalHints]:
        return None                      # no bit-identical reuse

    def launch(self, plan: RoundPlan) -> None:
        raise NotImplementedError

    def readback(self) -> RoundResult:
        result, self._result = self._result, None
        return result

    def on_clones(self, cloned: List[Tuple[int, int]]) -> None:
        pass

    def quiesce(self) -> None:
        """Snapshot barrier: drop any in-flight speculation so that a
        checkpoint reads settled state. Safe because speculative batches
        are repairable — the next launch simply trains synchronously.
        No-op for the synchronous engines."""

    def collect(self, preferred: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    # -- shared helpers ---------------------------------------------------
    def _maybe_compress(self, params: Params) -> Params:
        return qz.roundtrip(params, self.cfg.quantize_bits)

    def _holder_weights(self, plan: RoundPlan, m: int) -> np.ndarray:
        """Per-device aggregation weight for model ``m``: c_m_i on its
        work-pair devices, 0 elsewhere — the plan-based form of
        ``aggregate.participation_weights`` (the pair list IS
        ``participating & active``, so masking reduces to a gather)."""
        w = np.zeros(self.n_devices, np.float32)
        d = np.asarray(plan.pair_device,
                       np.int64)[np.asarray(plan.pair_model) == m]
        w[d] = plan.scores[d, m]
        return w

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32),
                               device=self._dev["train"][0].device)


class LegacyExecutor(RoundExecutor):
    """The original per-model loop: every model with work trains on ALL
    N devices (non-holders trained, then zero-weighted away by eq 1's
    single-model kernel), one call per model for training and for each
    eval. O(models x devices) work; kept as the equivalence oracle.
    Params live in the registry's dict mode, on the server's device."""

    def __init__(self, cfg, registry, databank, loss_fn, acc_fn,
                 batch_size: int):
        super().__init__(cfg, registry, databank)
        self.local_train = make_local_train(loss_fn, cfg.lr, batch_size)
        self.evaluate = make_eval(acc_fn)

    def launch(self, plan: RoundPlan) -> None:
        xs, ys = self._dev["train"]
        for m in plan.agg_models:
            trained = self.local_train(self.registry.params[m], xs, ys,
                                       plan.perms)
            w = self._tensor(self._holder_weights(plan, m))
            self.registry.params[m] = self._maybe_compress(
                weighted_average(trained, w))

        accs = np.zeros((self.n_devices, self.cfg.max_models))
        vx, vy = self._dev["val"]
        for m in plan.live:
            accs[:, m] = _host(self.evaluate(self.registry.params[m],
                                             vx, vy))
        self._result = RoundResult(accs)

    def collect(self, preferred: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
        tx, ty = self._dev["test"]
        vx, vy = self._dev["val"]
        test_acc = np.zeros(self.n_devices)
        val_acc = np.zeros(self.n_devices)
        for m in np.unique(preferred):
            sel = preferred == m
            if m not in self.registry.params:
                continue
            test_acc[sel] = _host(self.evaluate(
                self.registry.params[m], tx, ty))[sel]
            val_acc[sel] = _host(self.evaluate(
                self.registry.params[m], vx, vy))[sel]
        return test_acc, val_acc


class BatchedExecutor(RoundExecutor):
    """The batched engine: one call trains the gathered pairs and one
    multi-model aggregation averages them, then each model's row is
    transport-compressed on its own; dense (live, N) eval matrices are
    re-dispatched in ``collect``. Kept as the fused engine's baseline.
    Params live in the registry's dict mode, on the server's device."""

    def __init__(self, cfg, registry, databank, loss_fn, acc_fn,
                 batch_size: int):
        super().__init__(cfg, registry, databank)
        self.group_train = make_pair_train(loss_fn, cfg.lr)
        self.group_eval = make_group_eval(acc_fn)

    def _stack_params(self, model_ids: List[int], pad_to: int) -> Params:
        trees = [self.registry.params[m] for m in model_ids]
        return _stack(trees + [trees[0]] * (pad_to - len(trees)))

    def _eval_matrix(self, x: torch.Tensor, y: torch.Tensor
                     ) -> Tuple[np.ndarray, List[int]]:
        live = self.registry.live_ids()
        if not live:
            return np.zeros((0, self.n_devices)), live
        stacked = self._stack_params(live, bucket_size(len(live),
                                                       minimum=1))
        return _host(self.group_eval(stacked, x, y)), live

    def launch(self, plan: RoundPlan) -> None:
        xs, ys = self._dev["train"]
        agg_models = plan.agg_models
        if agg_models:
            b = len(plan.pair_model)
            m_pad = bucket_size(len(agg_models), minimum=1)
            slot = {m: j for j, m in enumerate(agg_models)}
            m_idx, d_idx, pperms = pad_work_batch(
                [slot[m] for m in plan.pair_model], plan.pair_device,
                [plan.perms[d] for d in plan.pair_device])
            stacked = self._stack_params(agg_models, m_pad)
            trained = self.group_train(stacked, m_idx, xs, ys, d_idx,
                                       pperms)
            w = np.zeros((m_pad, len(m_idx)), np.float32)
            w[m_idx[:b], np.arange(b)] = plan.scores[plan.pair_device,
                                                     plan.pair_model]
            agg = multi_weighted_average(trained, self._tensor(w))
            for j, m in enumerate(agg_models):
                self.registry.params[m] = self._maybe_compress(
                    {k: v[j] for k, v in agg.items()})

        accs = np.zeros((self.n_devices, self.cfg.max_models))
        mat, live = self._eval_matrix(*self._dev["val"])
        for j, m in enumerate(live):
            accs[:, m] = mat[j]
        self._result = RoundResult(accs)

    def collect(self, preferred: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
        test_acc = np.zeros(self.n_devices)
        val_acc = np.zeros(self.n_devices)
        test_mat, live = self._eval_matrix(*self._dev["test"])
        val_mat, _ = self._eval_matrix(*self._dev["val"])
        slot = {m: j for j, m in enumerate(live)}
        for i in range(self.n_devices):
            j = slot.get(int(preferred[i]))
            if j is not None:
                test_acc[i] = test_mat[j, i]
                val_acc[i] = val_mat[j, i]
        return test_acc, val_acc


class FusedExecutor(RoundExecutor):
    """The device-resident data plane: params live in the registry's
    stacked bank, a round trains its pairs (``make_pair_train``) and
    then aggregates, scatters into the bank in place and evaluates the
    stale rows (``make_fused_finish``). Owns the per-model eval-row
    caches and the test-row prediction. ``pipeline=True`` adds
    cross-round speculation (module docstring): a round then takes its
    training from the speculation when it still covers the plan. Owns
    the semi-synchronous carry-over buffer of harvested straggler rows.

    A dropped speculation needs no parking place (the reference keeps
    one, ``_spec_graveyard``, because destructing an in-flight JAX
    buffer blocks the host): PyTorch's caching allocator hands a freed
    block only to work ordered after it on the same stream, so dropping
    an enqueued batch never waits."""

    def __init__(self, cfg, registry, databank, loss_fn, acc_fn,
                 pipeline: bool = False):
        super().__init__(cfg, registry, databank)
        self.pipeline = pipeline
        self._eval = make_fused_eval(acc_fn)
        self._pair_eval = make_pair_eval(acc_fn)
        self._train = make_pair_train(loss_fn, cfg.lr)
        self._apply = make_fused_apply(cfg.quantize_bits)
        self._finish = make_fused_finish(acc_fn, cfg.quantize_bits)
        # eval-row caches: a model's params change ONLY when it trains or
        # is born, so its (N,) accuracy rows are reused until then
        self._val_cache: Dict[int, np.ndarray] = {}
        self._test_cache: Dict[int, np.ndarray] = {}
        self._pred_rows: List[int] = [0]
        self._needs_refresh = False
        self._pending: Optional[Tuple[RoundPlan, Dict[str, Callable]]] = \
            None
        self._spec: Optional[Tuple[RoundPlan, Params, TrainMeta,
                                   Tuple[int, int]]] = None
        self._last_plan: Optional[RoundPlan] = None
        # harvested straggler rows (on the server's device), blended back
        # in by ``_fold_stale`` when the planner says so
        self._stale_updates: Dict[StaleKey, Params] = {}
        self.stats = PipelineStats() if pipeline else None

    # -- id -> row resolution ---------------------------------------------
    def _rows(self, models: List[int]) -> List[int]:
        """Plans name models by id; the bank's ``row_of`` places them (the
        identity on one shard, until a restore re-places the ids)."""
        row_of = self.registry.params.row_of
        return [row_of[m] for m in models]

    def _drows(self, device_ids: List[int]) -> List[int]:
        """Plans name devices by id; the bank's ``row_of`` resolves their
        data rows at dispatch (the identity while there is no churn)."""
        row_of = self.databank.row_of
        return [row_of[d] for d in device_ids]

    def _to_id_row(self, vec: np.ndarray) -> np.ndarray:
        """Map one eval-matrix row (indexed by data row) to the device-id
        indexing of the control plane. The full-fleet identity keeps the
        static layout; any absence takes the explicit map, so DEPARTED
        devices' columns read 0 on every engine (their stale rows still
        compute values that must not leak into metrics)."""
        bank = self.databank
        if (bank.id_cap == bank.n_cap == bank.n_present
                and bank.identity_map()):
            return vec
        out = np.zeros(self.n_devices, vec.dtype)
        for d in bank.present_ids():
            out[d] = vec[bank.row_of[d]]
        return out

    # -- planning hints + lifecycle hooks ---------------------------------
    def plan_hints(self) -> EvalHints:
        return EvalHints(set(self._val_cache), set(self._test_cache),
                         list(self._pred_rows))

    def on_churn(self, joined: List[int], left: List[int],
                 drifted: List[int]) -> None:
        """Joins and drifts rewrite data-bank rows, so every cached
        per-model accuracy row holds stale columns: drop the caches and
        let the next plan mark the population stale (one full re-eval
        round). A pure leave changes no data: the departed device's
        cached entries are never read again (its active row is
        cleared)."""
        if joined or drifted:
            self._val_cache.clear()
            self._test_cache.clear()

    def on_clones(self, cloned: List[Tuple[int, int]]) -> None:
        if not cloned:
            return
        if self.cfg.quantize_bits:
            # clones are quantize roundtrips of their parents — cached
            # rows don't transfer; re-eval the population in collect
            self._needs_refresh = True
        else:
            # a clone's params are bit-identical to its parent's
            for parent, clone in cloned:
                if parent in self._val_cache:
                    self._val_cache[clone] = self._val_cache[parent]
                if parent in self._test_cache:
                    self._test_cache[clone] = self._test_cache[parent]

    # -- weight / batch builders ------------------------------------------
    def _apply_weights(self, meta: TrainMeta, plan: RoundPlan
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """(A_pad, B) weight matrix + padded agg row indices, addressed by
        META's pair columns (on a repaired speculation they are a superset
        of the plan's pairs: dead pairs score c=0 and models outside the
        plan's agg set get no weight row, so the superset aggregates
        identically)."""
        agg_rows = pad_live_rows(self._rows(plan.agg_models))
        slot = {m: j for j, m in enumerate(plan.agg_models)}
        w = np.zeros((len(agg_rows), meta.b_pad), np.float32)
        for k, (m, d) in enumerate(zip(meta.pair_model, meta.pair_device)):
            j = slot.get(m)
            if j is not None:
                w[j, k] = plan.scores[d, m]
        w[len(plan.agg_models):] = w[0]
        return w, agg_rows

    def _dispatch_train(self, pair_model: List[int],
                        pair_device: List[int], perms: np.ndarray
                        ) -> Tuple[Params, TrainMeta]:
        # m_idx / d_idx hold bank and data ROWS; perms stay indexed by
        # device id
        m_idx, d_idx, pperms = pad_work_batch(
            self._rows(pair_model), self._drows(pair_device),
            [perms[d] for d in pair_device])
        _note_train(len(pair_model), len(m_idx), len(m_idx))
        trained = self._train(self.registry.params.tree, m_idx,
                              *self._dev["train"], d_idx, pperms)
        return trained, TrainMeta(list(pair_model), list(pair_device),
                                  len(m_idx))

    def _dispatch_apply(self, trained: Params, meta: TrainMeta,
                        plan: RoundPlan) -> None:
        w, agg_rows = self._apply_weights(meta, plan)
        self._apply(self.registry.params.tree, trained, w, agg_rows)

    # -- eval dispatch / readers ------------------------------------------
    def _val_reader_dense(self, mat: torch.Tensor, models: List[int]
                          ) -> Callable:
        telemetry.count("eval_rows_read", len(models))
        read_mat = _host_async(mat)

        def read() -> Dict[int, np.ndarray]:
            rows = read_mat()[:len(models)]
            return {m: self._to_id_row(rows[j])
                    for j, m in enumerate(models)}
        return read

    def _val_reader_sparse(self, vec: torch.Tensor, plan: RoundPlan,
                           positions: Optional[List[int]] = None
                           ) -> Callable:
        """Merge sparse per-pair accuracies into full cached rows: pair
        k's value sits at ``positions[k]`` of the eval vector (the
        identity by default, shard-bucket slots on a mesh); untouched
        entries keep their cached value and never-scored rows start at
        zero (only active entries are ever read)."""
        read_vec = _host_async(vec)
        pos = positions or range(len(plan.val_pair_model))

        def read() -> Dict[int, np.ndarray]:
            v = read_vec()
            rows: Dict[int, np.ndarray] = {}
            for k, (m, d) in enumerate(zip(plan.val_pair_model,
                                           plan.val_pair_device)):
                if m not in rows:
                    rows[m] = self._val_cache.get(
                        m, np.zeros(self.n_devices)).copy()
                rows[m][d] = v[pos[k]]
            return rows
        return read

    def _dispatch_sparse_val(self, plan: RoundPlan) -> Callable:
        vec = self._pair_eval(self.registry.params.tree,
                              self._rows(plan.val_pair_model),
                              self._drows(plan.val_pair_device),
                              *self._dev["val"])
        return self._val_reader_sparse(vec, plan)

    def _dispatch_dense(self, models: List[int], split: str) -> Callable:
        mat = self._eval(self.registry.params.tree,
                         pad_live_rows(self._rows(models)),
                         *self._dev[split])
        return self._val_reader_dense(mat, models)

    def _dispatch_evals(self, plan: RoundPlan) -> Dict[str, Callable]:
        pend: Dict[str, Callable] = {}
        if plan.val_stale:
            pend["val"] = (self._dispatch_sparse_val(plan)
                           if plan.sparse_val
                           else self._dispatch_dense(plan.val_stale, "val"))
        if plan.test_stale:
            pend["test"] = self._dispatch_dense(plan.test_stale, "test")
        return pend

    # -- launch -----------------------------------------------------------
    def _readers(self, plan: RoundPlan, val_mat: torch.Tensor,
                 test_mat: torch.Tensor) -> Dict[str, Callable]:
        pend: Dict[str, Callable] = {}
        if plan.val_stale:
            pend["val"] = self._val_reader_dense(val_mat, plan.val_stale)
        if plan.test_stale:
            pend["test"] = self._val_reader_dense(test_mat, plan.test_stale)
        return pend

    def _finish_round(self, trained: Params, meta: TrainMeta,
                      plan: RoundPlan) -> Dict[str, Callable]:
        """Aggregate + scatter + stale-row eval as ONE call (the
        ``make_fused_finish`` program): everything a round does after
        training."""
        w, agg_rows = self._apply_weights(meta, plan)
        val_mat, test_mat = self._finish(
            self.registry.params.tree, trained, w, agg_rows,
            pad_live_rows(self._rows(plan.val_stale or plan.live[:1])),
            pad_live_rows(self._rows(plan.test_stale or plan.live[:1])),
            *self._dev["val"], *self._dev["test"])
        return self._readers(plan, val_mat, test_mat)

    # -- semi-synchronous fold ---------------------------------------------
    def _fold_stale(self, plan: RoundPlan) -> None:
        """Blend the plan's matured straggler updates into their models'
        bank rows, on the card, through the bank's item protocol, which
        bumps its ``version`` and so invalidates any speculation built on
        pre-fold params. Runs at launch, BEFORE dispatch: this round's
        training and eval see post-fold params. The quantize roundtrip
        follows the round's aggregate → quantize → scatter order."""
        matured = _matured(self._stale_updates, plan)
        if not matured:
            return
        with telemetry.span("launch/fold"):
            for m, mass, updates in matured:
                if m in self.registry.params:
                    new = _blend_stale(self.registry.params[m], mass,
                                       updates)
                    self.registry.params[m] = self._maybe_compress(new)

    def launch(self, plan: RoundPlan) -> None:
        """Fold, then train (or take the speculation), then finish: dense
        rounds in one finish call; sparse-val rounds, and rounds where no
        model aggregates, apply (if one does), then run the eval calls;
        rounds with nothing to train (no pairs, or every pair dropped)
        are eval-only. Straggler rows are harvested right after
        training."""
        self._last_plan = plan
        self._fold_stale(plan)
        self._note_load(plan)
        if plan.pair_model and (plan.agg_models or plan.straggler_pairs):
            with telemetry.span("launch/train"):
                spec = self._take_speculation(plan)
                if spec is None:
                    trained, meta = self._dispatch_train(
                        plan.pair_model, plan.pair_device, plan.perms)
                else:
                    trained, meta = spec
            if plan.straggler_pairs:
                _harvest_rows(self._stale_updates, plan, trained, meta)
            with telemetry.span("launch/finish"):
                if plan.sparse_val or not plan.agg_models:
                    if plan.agg_models:
                        self._dispatch_apply(trained, meta, plan)
                    pend = self._dispatch_evals(plan)
                else:
                    pend = self._finish_round(trained, meta, plan)
        else:
            self._drop_speculation()
            with telemetry.span("launch/finish"):
                pend = self._dispatch_evals(plan)
        self._pending = (plan, pend)

    def _note_load(self, plan: RoundPlan) -> None:
        """The sharded executors observe each round's per-shard load here,
        after the fold and before any bucketing."""

    # -- speculation ------------------------------------------------------
    def _discard_spec(self, invalidated: bool) -> None:
        """Abandon the pending speculation. ``invalidated`` separates
        launch-time staleness (clones) from never-consumed batches
        (extinction / no-pair rounds) in the stats."""
        self._spec = None
        if invalidated:
            self.stats.invalidated += 1
        else:
            self.stats.discarded += 1

    def _drop_speculation(self) -> None:
        if self._spec is not None:
            self._discard_spec(invalidated=False)

    def quiesce(self) -> None:
        """Snapshot barrier: discard the in-flight speculative batch (the
        resumed round trains synchronously and computes identical
        params). The reference also frees its graveyard and retired bank
        trees here; the port keeps neither (class docstring)."""
        self._drop_speculation()

    def _take_speculation(self, plan: RoundPlan
                          ) -> Optional[Tuple[Params, TrainMeta]]:
        """Consume the pending speculative train batch if it still covers
        the true plan: deletions and device leaves only shrink the pair
        set, so a superset batch is repairable (dead pairs aggregate with
        zero weight); clones add pairs and rewrite PARAM bank rows, folds
        rewrite them too, and joins and drifts rewrite DATA bank rows, so
        a version mismatch retrains from scratch."""
        if self._spec is None:
            return None
        spec_plan, trained, meta, versions = self._spec
        if (spec_plan.round != plan.round
                or (self.registry.params.version,
                    self.databank.version) != versions):
            self._discard_spec(invalidated=True)
            return None
        covered = set(zip(meta.pair_model, meta.pair_device))
        if any(p not in covered for p in plan.pairs()):
            self._discard_spec(invalidated=True)
            return None
        self._spec = None
        if len(plan.pair_model) == len(meta.pair_model):
            self.stats.hit += 1
        else:
            self.stats.repaired += 1
        return trained, meta

    def speculate(self, plan: RoundPlan) -> None:
        if not self.pipeline:
            return
        self._drop_speculation()
        if self._last_plan is not None and (
                self._last_plan.clone_milestone
                or self._last_plan.churn_next
                or self._last_plan.fold_next):
            # pending lifecycle intent: milestone clones rewrite param
            # rows and add pairs; next-round device churn rewrites data
            # rows / changes the cohort; a next-round stale fold rewrites
            # param rows at launch — don't burn a dispatch
            self.stats.skipped += 1
            return
        if not plan.pair_model:
            return
        trained, meta = self._dispatch_train(
            plan.pair_model, plan.pair_device, plan.perms)
        self._spec = (plan, trained, meta,
                      (self.registry.params.version,
                       self.databank.version))
        self.stats.speculated += 1

    # -- readback + collect -----------------------------------------------
    def readback(self) -> RoundResult:
        plan, pend = self._pending
        self._pending = None
        if "val" in pend:
            self._val_cache.update(pend["val"]())
        if "test" in pend:
            self._test_cache.update(pend["test"]())
        # a changed model's (aggregated or stale-folded) old test row is
        # stale: drop it unless it was just re-evaluated
        for m in plan.changed_models():
            if m not in plan.test_stale:
                self._test_cache.pop(m, None)
        accs = np.zeros((self.n_devices, self.cfg.max_models))
        for m in plan.live:
            accs[:, m] = self._val_cache[m]
        return RoundResult(accs)

    def eval_rows(self, rows: List[int], split: str) -> np.ndarray:
        """(len(rows), N) accuracy of the given models on one split."""
        telemetry.count("eval_rows_read", len(rows))
        mat = self._eval(self.registry.params.tree,
                         pad_live_rows(self._rows(rows)), *self._dev[split])
        return np.stack([self._to_id_row(r)
                         for r in _host(mat)[:len(rows)]])

    def _refresh_caches(self) -> None:
        """Quantized cloning made every clone's params differ from its
        parent's: re-score the whole live population once."""
        live = self.registry.live_ids()
        if not live:
            self._val_cache, self._test_cache = {}, {}
            return
        telemetry.count("refresh_rows", len(live))
        val = self.eval_rows(live, "val")
        test = self.eval_rows(live, "test")
        self._val_cache = {m: val[j] for j, m in enumerate(live)}
        self._test_cache = {m: test[j] for j, m in enumerate(live)}

    def collect(self, preferred: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
        if self._needs_refresh:
            self._refresh_caches()
            self._needs_refresh = False
        entries = self.registry.entries
        wanted = [int(m) for m in preferred]
        # departed (or not yet joined) devices report no accuracy
        usable = [m if (m in entries and entries[m].alive
                        and m in self._val_cache
                        and i in self.databank) else None
                  for i, m in enumerate(wanted)]
        missing = sorted({m for m in usable
                          if m is not None and m not in self._test_cache})
        if missing:
            # test-row prediction missed (a preference shifted to a model
            # that didn't train): one small dense eval
            telemetry.count("test_row_misses", len(missing))
            extra = self.eval_rows(missing, "test")
            for j, m in enumerate(missing):
                self._test_cache[m] = extra[j]
        test_acc = np.zeros(self.n_devices)
        val_acc = np.zeros(self.n_devices)
        for i, m in enumerate(usable):
            if m is not None:
                test_acc[i] = self._test_cache[m][i]
                val_acc[i] = self._val_cache[m][i]
        # predict next round's test rows: what devices prefer now
        self._pred_rows = sorted({m for m in usable if m is not None})
        return test_acc, val_acc


class ShardedExecutor(FusedExecutor):
    """The fused data plane over a 1-D ``model``-axis launch mesh (port of
    ``repro/federated/executors.py:877-1096``): bank rows and work pairs
    bucket per owning shard, each shard trains, aggregates (eq 1 through
    the kernel, one grouped launch per shard with work), round-trips and
    scatters only its resident rows, and only the small row-sharded eval
    matrices cross back. Feeds the observed per-shard pair load into the
    bank's work-aware row placement every round and, with
    ``migrate_threshold``, migrates a row off a hot shard before the
    round's bucketing. Launch, speculation, repair, harvest, fold,
    readback and the eval-row caches are the fused executor's.

    Row schedules pad with ``minimum=1``: the reference's pipelined
    ``_row_floor`` (4) exists to stop its programs retracing, which the
    port's do not; it changes padding widths only, never results."""

    def __init__(self, cfg, registry, databank, loss_fn, acc_fn,
                 mesh: LaunchMesh, pipeline: bool = False,
                 migrate_threshold: Optional[float] = None):
        super().__init__(cfg, registry, databank, loss_fn, acc_fn,
                         pipeline=pipeline)
        self.mesh = mesh
        self._n_shards = model_axis_size(mesh)
        self._rows_per_shard = bank_rows_per_shard(cfg.max_models, mesh)
        self.migrate_threshold = migrate_threshold
        self.migrations = 0
        self._train = make_sharded_train(loss_fn, cfg.lr, mesh)
        self._apply = (make_sharded_apply if data_axis_size(mesh) == 1
                       else make_sharded2d_apply)(mesh, cfg.quantize_bits)
        self._finish = make_sharded_finish(acc_fn, mesh, cfg.quantize_bits)
        self._eval = make_sharded_eval(acc_fn, mesh)
        self._pair_eval = make_sharded_pair_eval(acc_fn, mesh)

    def _note_load(self, plan: RoundPlan) -> None:
        counts = np.zeros(self._n_shards)
        for r in self._rows(plan.pair_model):
            counts[r // self._rows_per_shard] += 1
        self.registry.params.note_pair_load(counts)
        if self.migrate_threshold is not None:
            # rebalance BEFORE this round's bucketing so the moved row's
            # pairs land on its new shard; the bank version bump
            # invalidates any speculation built on the old placement
            self.migrations += len(
                self.registry.params.rebalance(self.migrate_threshold))

    def _shard_row_slots(self, models: List[int]
                         ) -> Tuple[np.ndarray, Dict[int, int], List[bool]]:
        """LOCAL row buckets for ``models``, each model's slot in the
        (S*L, N) output, and which shards hold any of them."""
        row_of = self.registry.params.row_of
        idx, groups, width = shard_rows(self._rows(models),
                                        self._rows_per_shard,
                                        self._n_shards)
        slot = {r: s * width + j
                for s, g in enumerate(groups) for j, r in enumerate(g)}
        return idx, {m: slot[row_of[m]] for m in models}, \
            [bool(g) for g in groups]

    def _bucket(self, pair_model: List[int], pair_device: List[int],
                perms: np.ndarray):
        # the per-shard bucket floor scales down with the shard count:
        # the global work splits S ways
        return shard_work_batch(
            self._rows(pair_model), self._drows(pair_device),
            [perms[d] for d in pair_device], self._rows_per_shard,
            self._n_shards, minimum=max(8 // self._n_shards, 2))

    def _dispatch_train(self, pair_model: List[int],
                        pair_device: List[int], perms: np.ndarray
                        ) -> Tuple[List[Optional[Params]], TrainMeta]:
        m_idx, d_idx, pperms, groups, width = self._bucket(
            pair_model, pair_device, perms)
        _note_train(len(pair_model), width * sum(1 for g in groups if g),
                    width)
        trained = self._train(self.registry.params, self.databank, m_idx,
                              d_idx, pperms, [len(g) for g in groups])
        return trained, TrainMeta(
            list(pair_model), list(pair_device), width, groups,
            _group_positions(groups, width, len(pair_model)))

    def _shard_agg_plan(self, agg_models: List[int], meta: TrainMeta,
                        c: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-shard aggregation schedule: LOCAL agg row indices (S*A,),
        the (S*A, B) weight blocks and the keep mask guarding the
        scatter. Pairs are addressed by META's bucket columns; a repaired
        speculation's dead pairs find no slot (their model left the agg
        set) or score c=0. Padding rows repeat the shard's first row and
        its weight row, so duplicate scatter indices carry equal
        values."""
        S = self._n_shards
        row_of = self.registry.params.row_of
        agg_idx, agg_groups, a_pad = shard_rows(
            self._rows(agg_models), self._rows_per_shard, S)
        keep = np.zeros(S * a_pad, bool)
        w = np.zeros((S * a_pad, meta.b_pad), np.float32)
        for s, group in enumerate(agg_groups):
            if not group:
                continue
            base = s * a_pad
            keep[base:base + a_pad] = True
            slot = {r: j for j, r in enumerate(group)}
            for col, k in enumerate(meta.pair_groups[s]):
                m, d = meta.pair_model[k], meta.pair_device[k]
                j = slot.get(row_of[m])
                if j is not None:
                    w[base + j, col] = c[d, m]
            w[base + len(group):base + a_pad] = w[base]
        return agg_idx, keep, w

    def _dispatch_apply(self, trained: List[Optional[Params]],
                        meta: TrainMeta, plan: RoundPlan) -> None:
        agg_idx, keep, w = self._shard_agg_plan(plan.agg_models, meta,
                                                plan.scores)
        self._apply(self.registry.params, trained, w, agg_idx, keep)

    def _sharded_reader(self, mat: torch.Tensor, slots: Dict[int, int]
                        ) -> Callable:
        telemetry.count("eval_rows_read", len(slots))
        read_mat = _host_async(mat)

        def read() -> Dict[int, np.ndarray]:
            rows = read_mat()
            return {m: self._to_id_row(rows[j]) for m, j in slots.items()}
        return read

    def _finish_round(self, trained: List[Optional[Params]],
                      meta: TrainMeta, plan: RoundPlan
                      ) -> Dict[str, Callable]:
        agg_idx, keep, w = self._shard_agg_plan(plan.agg_models, meta,
                                                plan.scores)
        vidx, vslot, vrun = self._shard_row_slots(plan.val_stale)
        tidx, tslot, trun = self._shard_row_slots(plan.test_stale)
        val_mat, test_mat = self._finish(
            self.registry.params, self.databank, trained, w, agg_idx, keep,
            vidx, vrun, tidx, trun)
        pend: Dict[str, Callable] = {}
        if plan.val_stale:
            pend["val"] = self._sharded_reader(val_mat, vslot)
        if plan.test_stale:
            pend["test"] = self._sharded_reader(test_mat, tslot)
        return pend

    def _dispatch_dense(self, models: List[int], split: str) -> Callable:
        idx, slots, run = self._shard_row_slots(models)
        mat = self._eval(self.registry.params, self.databank, idx, split,
                         run)
        return self._sharded_reader(mat, slots)

    def _pair_buckets(self, plan: RoundPlan):
        return shard_eval_pairs(
            self._rows(plan.val_pair_model),
            self._drows(plan.val_pair_device), self._rows_per_shard,
            self._n_shards, minimum=max(8 // self._n_shards, 2))

    def _dispatch_sparse_val(self, plan: RoundPlan) -> Callable:
        m_idx, d_idx, groups, width = self._pair_buckets(plan)
        vec = self._pair_eval(self.registry.params, self.databank, m_idx,
                              d_idx, "val", [len(g) for g in groups])
        return self._val_reader_sparse(
            vec, plan, _group_positions(groups, width,
                                        len(plan.val_pair_model)))

    def eval_rows(self, rows: List[int], split: str) -> np.ndarray:
        idx, slots, run = self._shard_row_slots(rows)
        telemetry.count("eval_rows_read", len(rows))
        mat = _host(self._eval(self.registry.params, self.databank, idx,
                               split, run))
        return np.stack([self._to_id_row(mat[slots[m]]) for m in rows])


class Sharded2DExecutor(ShardedExecutor):
    """The data plane on the full 2-D ``(model × data)`` launch mesh (port
    of ``repro/federated/executors.py:1099-1217``): the param bank's rows
    shard over ``model`` as in :class:`ShardedExecutor`, the data bank's
    rows over ``data``, and work pairs bucket by owning CELL (model shard
    of the pair's bank row × data shard of its data row). The one new
    cross-cell step is the data-axis sum completing eq 1 (a model's
    holders may live on several data shards), plain PyTorch as in the
    reference; the transport round trip stays the kernels', per model
    shard. Discrete state matches the 1-data-shard plane exactly, params
    to reduction order."""

    def __init__(self, cfg, registry, databank, loss_fn, acc_fn,
                 mesh: LaunchMesh, pipeline: bool = False,
                 migrate_threshold: Optional[float] = None):
        self._n_dshards = data_axis_size(mesh)
        super().__init__(cfg, registry, databank, loss_fn, acc_fn, mesh,
                         pipeline=pipeline,
                         migrate_threshold=migrate_threshold)

    @property
    def _n_cells(self) -> int:
        return self._n_shards * self._n_dshards

    def _note_load(self, plan: RoundPlan) -> None:
        # model-axis load -> param bank (inherited), plus the data-axis
        # twin: per-data-shard pair counts feed the data bank's placement
        super()._note_load(plan)
        counts = np.zeros(self._n_dshards)
        for d in plan.pair_device:
            counts[self.databank.shard_of(d)] += 1
        self.databank.note_pair_load(counts)

    def _bucket(self, pair_model: List[int], pair_device: List[int],
                perms: np.ndarray):
        # the global work splits Sm*Sd ways: the floor scales with cells
        return shard_pairs_2d(
            self._rows(pair_model), self._drows(pair_device),
            [perms[d] for d in pair_device], self._rows_per_shard,
            self._n_shards, self.databank.rows_per_shard,
            self._n_dshards, minimum=max(8 // self._n_cells, 2))

    def _shard_agg_plan(self, agg_models: List[int], meta: TrainMeta,
                        c: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The 2-D schedule: LOCAL agg row indices (Sm*A,), the
        (Sm*A, Sd*B) weight grid — block (sm, sd) pairs model shard sm's
        agg rows with cell (sm, sd)'s bucket columns — and the keep
        mask. Padding agg rows repeat the shard's first row's FULL weight
        row (every data block), so duplicate scatter indices carry equal
        post-sum values; empty model shards keep their rows."""
        S_m, S_d = self._n_shards, self._n_dshards
        row_of = self.registry.params.row_of
        agg_idx, agg_groups, a_pad = shard_rows(
            self._rows(agg_models), self._rows_per_shard, S_m)
        keep = np.zeros(S_m * a_pad, bool)
        w = np.zeros((S_m * a_pad, S_d * meta.b_pad), np.float32)
        for sm, group in enumerate(agg_groups):
            if not group:
                continue
            base = sm * a_pad
            keep[base:base + a_pad] = True
            slot = {r: j for j, r in enumerate(group)}
            for sd in range(S_d):
                cbase = sd * meta.b_pad
                for col, k in enumerate(meta.pair_groups[sm * S_d + sd]):
                    m, d = meta.pair_model[k], meta.pair_device[k]
                    j = slot.get(row_of[m])
                    if j is not None:
                        w[base + j, cbase + col] = c[d, m]
            w[base + len(group):base + a_pad] = w[base]
        return agg_idx, keep, w

    def _pair_buckets(self, plan: RoundPlan):
        return shard_eval_pairs_2d(
            self._rows(plan.val_pair_model),
            self._drows(plan.val_pair_device), self._rows_per_shard,
            self._n_shards, self.databank.rows_per_shard,
            self._n_dshards, minimum=max(8 // self._n_cells, 2))


# -- FedAvg executor ----------------------------------------------------------

@dataclass
class FedAvgResult:
    val_acc: np.ndarray                  # (N,)
    test_acc: np.ndarray                 # (N,)


class FedAvgHostExecutor:
    """The legacy / batched FedAvg paths: the global model is a param
    dict on the server's device, replaced each round. Legacy trains it on
    every device and averages the participants with the single-model
    kernel; batched trains only the participants and averages them with
    the multi-model kernel's one-row case."""

    def __init__(self, cfg: FedCDConfig, databank: DeviceDataBank,
                 init_params: Params, loss_fn, acc_fn, batch_size: int,
                 batched: bool):
        self.cfg = cfg
        self.databank = databank
        self.n_devices = databank.id_cap
        self.params = init_params
        self.batched = batched
        if batched:
            self.group_train = make_pair_train(loss_fn, cfg.lr)
        else:
            self.local_train = make_local_train(loss_fn, cfg.lr,
                                                batch_size)
        self.evaluate = make_eval(acc_fn)
        self._result: Optional[FedAvgResult] = None
        self.stats: Optional[PipelineStats] = None

    def get_params(self) -> Params:
        return self.params

    def set_params(self, value: Params) -> None:
        device = self.databank.splits["train"][0].device
        self.params = {k: torch.as_tensor(v).to(device)
                       for k, v in value.items()}

    def quiesce(self) -> None:
        pass                             # snapshot barrier: synchronous

    def launch(self, plan: RoundPlan) -> None:
        xs, ys = self.databank.splits["train"]
        if self.batched:
            d_ids = plan.pair_device
            b = len(d_ids)
            m_idx, d_idx, pp = pad_work_batch(
                [0] * b, list(d_ids), [plan.perms[d] for d in d_ids])
            stacked = {k: v[None] for k, v in self.params.items()}
            trained = self.group_train(stacked, m_idx, xs, ys, d_idx, pp)
            w = torch.zeros((1, len(m_idx)), dtype=torch.float32,
                            device=xs.device)
            w[0, :b] = 1.0
            agg = multi_weighted_average(trained, w)
            self.params = {k: v[0] for k, v in agg.items()}
        else:
            trained = self.local_train(self.params, xs, ys, plan.perms)
            w = torch.as_tensor(plan.participating.astype(np.float32),
                                device=xs.device)
            self.params = weighted_average(trained, w)
        vx, vy = self.databank.splits["val"]
        tx, ty = self.databank.splits["test"]
        self._result = FedAvgResult(
            val_acc=_host(self.evaluate(self.params, vx, vy)),
            test_acc=_host(self.evaluate(self.params, tx, ty)))

    def readback(self) -> FedAvgResult:
        result, self._result = self._result, None
        return result


class _GlobalModel:
    """FedAvg's global model as a ``(1, ...)`` bank (``stacked``, also
    ``tree``: one row, which every model shard holds) on its owner
    device; a cell on another device reads a copy refreshed after each
    write (``mark_written``)."""

    rows_per_shard = 0

    def __init__(self, stacked: Params):
        self.stacked = self.tree = stacked
        self._stamp = 0
        self._replicas = Replicas()

    def resident(self, sm: int, device: torch.device) -> Params:
        return self._replicas.get(0, self._stamp, self.stacked,
                                  torch.device(device))

    def mark_written(self) -> None:
        self._stamp += 1


class FedAvgFusedExecutor:
    """Device-resident FedAvg: the global model is row 0 of a (1, ...)
    bank; a round trains the participants (``make_pair_train``) and
    finishes with one-row buckets (``make_fused_finish``), updating the
    bank in place. ``pipeline=True`` enqueues the next round's training
    before this round's eval rows are read back. Semi-synchronous rounds
    harvest straggler rows and fold them back in on the card, as
    :class:`FusedExecutor` does; a round whose every pair straggled or
    dropped only evaluates (``_dispatch_eval_only``)."""

    def __init__(self, cfg: FedCDConfig, databank: DeviceDataBank,
                 init_params: Dict[str, torch.Tensor], loss_fn, acc_fn,
                 pipeline: bool = False):
        self.cfg = cfg
        self.databank = databank
        self.n_devices = databank.id_cap
        self.pipeline = pipeline
        self._model = _GlobalModel({k: v[None].clone()
                                    for k, v in init_params.items()})
        self._train = make_pair_train(loss_fn, cfg.lr)
        self._finish = make_fused_finish(acc_fn)
        self._evalp = make_fused_eval(acc_fn)
        self._pending: Optional[Tuple[Callable, Callable]] = None
        self._spec: Optional[Tuple[int, Params, TrainMeta]] = None
        self._last_plan: Optional[RoundPlan] = None
        self._stale_updates: Dict[StaleKey, Params] = {}
        self.stats = PipelineStats() if pipeline else None

    @property
    def _dev(self) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        return self.databank.splits

    @property
    def _stacked(self) -> Params:
        return self._model.stacked

    def get_params(self) -> Dict[str, torch.Tensor]:
        return {k: v[0] for k, v in self._stacked.items()}

    def set_params(self, value: Dict[str, torch.Tensor]) -> None:
        for k, v in self._stacked.items():
            v[0].copy_(torch.as_tensor(value[k]))
        self._model.mark_written()
        self._park_spec()                # the bank was rewritten

    def quiesce(self) -> None:
        """Snapshot barrier: drop any speculative round before the bank is
        read."""
        self._park_spec()

    def _park_spec(self) -> None:
        """Drop a pending speculation (no parking place is needed: see
        :class:`FusedExecutor`)."""
        self._spec = None

    # -- semi-synchronous fold ---------------------------------------------
    def _fold_stale(self, plan: RoundPlan) -> None:
        """Blend buffered straggler updates into the global model (id 0)
        on the card, BEFORE this round's dispatch; ``set_params`` drops a
        pending speculation, which read pre-fold params."""
        matured = _matured(self._stale_updates, plan)
        if not matured:
            return
        with telemetry.span("launch/fold"):
            for _, mass, updates in matured:
                self.set_params(_blend_stale(self.get_params(), mass,
                                             updates))

    # -- split-phase pieces -------------------------------------------------
    def _dispatch_train(self, plan: RoundPlan) -> Tuple[Params, TrainMeta]:
        d_ids = plan.pair_device
        m_idx, d_idx, pp = pad_work_batch(
            [0] * len(d_ids), list(d_ids), [plan.perms[d] for d in d_ids])
        _note_train(len(d_ids), len(m_idx), len(m_idx))
        trained = self._train(self._stacked, m_idx, *self._dev["train"],
                              d_idx, pp)
        return trained, TrainMeta([0] * len(d_ids), list(d_ids), len(m_idx))

    def _dispatch_finish(self, trained: Params, meta: TrainMeta,
                         plan: RoundPlan
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        # weights come from the TRUE plan (1 per participating pair)
        w = np.zeros((1, meta.b_pad), np.float32)
        for k, d in enumerate(meta.pair_device):
            w[0, k] = plan.scores[d, 0]
        row = np.zeros(1, np.int32)
        return self._finish(self._stacked, trained, w, row, row, row,
                            *self._dev["val"], *self._dev["test"])

    def _dispatch_eval_only(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """A round whose every pair straggled or dropped: the global
        model keeps its (post-fold) params; only the eval rows run."""
        row = np.zeros(1, np.int32)
        return (self._evalp(self._stacked, row, *self._dev["val"]),
                self._evalp(self._stacked, row, *self._dev["test"]))

    def launch(self, plan: RoundPlan) -> None:
        self._last_plan = plan
        self._fold_stale(plan)           # drops any (pre-fold) speculation
        trained = meta = None
        if plan.agg_models or plan.straggler_pairs:
            with telemetry.span("launch/train"):
                if self._spec is not None and self._spec[0] == plan.round:
                    _, trained, meta = self._spec
                    self._spec = None
                    self.stats.hit += 1
                else:
                    self._park_spec()
                    trained, meta = self._dispatch_train(plan)
        if plan.straggler_pairs:
            _harvest_rows(self._stale_updates, plan, trained, meta)
        with telemetry.span("launch/finish"):
            if plan.agg_models:
                val_mat, test_mat = self._dispatch_finish(trained, meta,
                                                          plan)
            else:
                val_mat, test_mat = self._dispatch_eval_only()
            telemetry.count("eval_rows_read", 2)
            self._pending = (_host_async(val_mat), _host_async(test_mat))

    def speculate(self, plan: RoundPlan) -> None:
        if not self.pipeline:
            return
        if self._last_plan is not None and self._last_plan.fold_next:
            # round t+1 folds stale updates into the bank first: training
            # against pre-fold params would be wasted
            self.stats.skipped += 1
            return
        trained, meta = self._dispatch_train(plan)
        self._spec = (plan.round, trained, meta)
        self.stats.speculated += 1

    def readback(self) -> FedAvgResult:
        read_val, read_test = self._pending
        self._pending = None
        return FedAvgResult(val_acc=read_val()[0], test_acc=read_test()[0])


class FedAvgShardedExecutor(FedAvgFusedExecutor):
    """FedAvg's fused round with the work-PAIR axis sharded over the
    mesh's ``model`` axis (port of ``repro/federated/executors.py:
    1482-1559``): one global model, replicated; participating devices
    deal round-robin over the shards, each shard trains its block and
    reduces a partial weighted sum, and one sum over the shards
    completes eq 1 (plain PyTorch, as in the reference)."""

    def __init__(self, cfg, databank, init_params, loss_fn, acc_fn,
                 mesh: LaunchMesh, pipeline: bool = False):
        super().__init__(cfg, databank, init_params, loss_fn, acc_fn,
                         pipeline=pipeline)
        self.mesh = mesh
        self._n_shards = model_axis_size(mesh)
        self._train = make_sharded_train(loss_fn, cfg.lr, mesh)
        self._finish = make_sharded_fedavg_finish(acc_fn, mesh)
        self._evalp = make_sharded_fedavg_eval(acc_fn, mesh)

    def _shard_batch(self, plan: RoundPlan):
        """Deal the participating devices round-robin over the shards and
        pad each shard's block to one shared bucket (zero-weight padding
        pairs). Pair weights come from ``plan.scores`` (1 on time, 0
        weight-zeroed). Returns (m_idx, d_idx, perms, w, groups, width);
        ``groups[s]`` lists shard s's pair positions."""
        S = self._n_shards
        d_ids = np.asarray(plan.pair_device, np.int64)
        groups = [list(range(s, len(d_ids), S)) for s in range(S)]
        width = bucket_size(max(len(g) for g in groups),
                            minimum=max(8 // S, 2))
        return self._fill(plan, groups, width, d_ids)

    def _fill(self, plan: RoundPlan, groups: List[List[int]], width: int,
              rows: np.ndarray):
        n = len(groups) * width
        m_idx = np.zeros(n, np.int32)
        d_idx = np.zeros(n, np.int32)
        pp = np.zeros((n,) + plan.perms[0].shape, np.int32)
        w = np.zeros(n, np.float32)
        for c, g in enumerate(groups):
            base = c * width
            for j, k in enumerate(g):
                d = plan.pair_device[k]
                d_idx[base + j] = rows[k]
                pp[base + j] = plan.perms[d]
                w[base + j] = plan.scores[d, 0]
        return m_idx, d_idx, pp, w, groups, width

    def _dispatch_train(self, plan: RoundPlan
                        ) -> Tuple[List[Optional[Params]], TrainMeta]:
        m_idx, d_idx, pp, _, groups, width = self._shard_batch(plan)
        _note_train(len(plan.pair_device),
                    width * sum(1 for g in groups if g), width)
        trained = self._train(self._model, self.databank, m_idx, d_idx, pp,
                              [len(g) for g in groups])
        b = len(plan.pair_device)
        return trained, TrainMeta([0] * b, list(plan.pair_device), width,
                                  groups, _group_positions(groups, width, b))

    def _dispatch_finish(self, trained: List[Optional[Params]],
                         meta: TrainMeta, plan: RoundPlan
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        # weights come from the TRUE plan (1 per on-time pair)
        w = np.zeros(len(trained) * meta.b_pad, np.float32)
        for d, p in zip(meta.pair_device, meta.positions):
            w[p] = plan.scores[d, 0]
        return self._finish(self._model, self.databank, trained, w)

    def _dispatch_eval_only(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return (self._evalp(self._model.resident, self.databank, "val"),
                self._evalp(self._model.resident, self.databank, "test"))


class FedAvgSharded2DExecutor(FedAvgShardedExecutor):
    """FedAvg on the full 2-D ``(model × data)`` launch mesh (port of
    ``repro/federated/executors.py:1562-1657``): the device data's rows
    shard over ``data``, each participating device's pair runs on a cell
    of its owning data slice (dealt round-robin over the ``model`` axis
    within the slice), one sum over BOTH axes completes eq 1, and each
    data slice scores the global model on its own devices."""

    def __init__(self, cfg, databank, init_params, loss_fn, acc_fn,
                 mesh: LaunchMesh, pipeline: bool = False):
        self._n_dshards = data_axis_size(mesh)
        n = databank.n_present          # FedAvg's population is static
        if n % self._n_dshards:
            raise ValueError(
                f"n_devices={n} must divide evenly over the data axis "
                f"({self._n_dshards} shards)")
        self._rows_per_dshard = n // self._n_dshards
        super().__init__(cfg, databank, init_params, loss_fn, acc_fn, mesh,
                         pipeline=pipeline)

    def _shard_batch(self, plan: RoundPlan):
        """Bucket pairs per owning mesh cell: device d lives in data shard
        ``d // rows_per_dshard``; within the slice pairs deal round-robin
        over the model axis. Cells are model-major (``cell = sm * Sd +
        sd``); padding pairs carry zero weight."""
        Sm, Sd = self._n_shards, self._n_dshards
        groups: List[List[int]] = [[] for _ in range(Sm * Sd)]
        dealt = [0] * Sd
        for k, d in enumerate(plan.pair_device):
            sd = d // self._rows_per_dshard
            groups[(dealt[sd] % Sm) * Sd + sd].append(k)
            dealt[sd] += 1
        width = bucket_size(max((len(g) for g in groups), default=0),
                            minimum=2)
        rows = np.asarray(plan.pair_device, np.int64) % self._rows_per_dshard
        return self._fill(plan, groups, width, rows)


# -- mode-B LM executors (DESIGN.md §14) ----------------------------------

class LLMExecutorBase(RoundExecutor):
    """Shared scaffolding for the mode-B LM executors driven by
    ``federated.llm.FedLLMTrainer``. Unlike the mode-A executors the
    round's token batches are drawn host-side by the trainer (the LM data
    plane has no data bank), so the trainer hands them over through
    :meth:`set_batches` before ``launch``. Train and accuracy steps come
    from ``launch.steps.make_train_step`` / ``llm.make_acc_step``; the
    train step updates its params in place."""

    def __init__(self, fed: FedCDConfig, registry: ModelRegistry,
                 n_clients: int, device: torch.device):
        # deliberately NOT RoundExecutor.__init__ — there is no mode-A
        # data plane to adopt
        self.cfg = fed
        self.registry = registry
        self.databank = None
        self.n_devices = n_clients
        self.device = torch.device(device)
        self._result: Optional[RoundResult] = None
        self._batches = None
        self._pending: Optional[RoundPlan] = None
        self.round_losses: List[float] = []

    def set_batches(self, tokens: np.ndarray, labels: np.ndarray,
                    vt: np.ndarray, vl: np.ndarray) -> None:
        """Hand this round's (train, val) token batches to the executor
        (host arrays, uploaded once per round through pinned memory)."""
        self._batches = tuple(to_device(a, np.int64, self.device)
                              for a in (tokens, labels, vt, vl))

    def _train_sets(self, plan: RoundPlan
                    ) -> Tuple[List[int], List[np.ndarray]]:
        """Models that actually train this round + their per-client
        weight rows: the plan's agg set minus models whose weight mass
        is zero (scores can underflow to 0 for every holder — the
        legacy loop's ``w.sum() <= 0`` skip, kept so both engines train
        the identical set)."""
        models, weights = [], []
        for m in plan.agg_models:
            w = self._holder_weights(plan, m)
            if w.sum() <= 0:
                continue
            models.append(m)
            weights.append(w)
        return models, weights

    def readback(self) -> RoundResult:
        self._pending = None
        result, self._result = self._result, None
        return result

    def params_of(self, m: int) -> Params:
        """Model ``m``'s current params — its dict entry (legacy) or its
        bank row's views (stacked); a tensor-parallel bank's row gathered
        whole on cell ``(0, 0)`` (a copy). The serving plane's
        :class:`~repro_torch.serve.draft.DraftBank` refresh reads through
        this, so draft truncation always sees post-round weights."""
        row = self.registry.params[m]
        return {k: v.full(v.device) if isinstance(v, Sharded) else v
                for k, v in row.items()}

    def collect(self, preferred: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError(
            "the LM path has no test split / preferred-model collection")


class LLMLegacyExecutor(LLMExecutorBase):
    """The per-model loop over dict-mode registry storage — the LM
    plane's equivalence oracle: every model trains and evaluates on its
    own, and the host reads each loss and accuracy row as it comes."""

    def __init__(self, fed, registry, n_clients, train_fn, acc_fn,
                 device: torch.device):
        super().__init__(fed, registry, n_clients, device)
        self._train = train_fn
        self._acc = acc_fn

    def launch(self, plan: RoundPlan) -> None:
        tokens, labels, vt, vl = self._batches
        losses = []
        for m, w in zip(*self._train_sets(plan)):
            _, met = self._train(self.registry.params[m], tokens, labels,
                                 to_device(w, np.float32, self.device),
                                 None)
            losses.append(float(met["loss"]))
        self.round_losses = losses
        accs = np.zeros((self.n_devices, self.cfg.max_models))
        for m in plan.live:
            accs[:, m] = _host(self._acc(self.registry.params[m], vt, vl))
        self._result = RoundResult(accs)
        self._pending = plan


class FedLLMExecutor(LLMExecutorBase):
    """The stacked LM engine: params live in a per-layer-stacked
    ``StackedParamBank`` and the round trains each training row of the
    bank in place, then scores every live row (``simulation.
    make_llm_round``), all enqueued without waiting for the card; the
    losses and the accuracy matrix come back through pinned copies that
    :meth:`readback` waits on. The model-row axis is a pure batch axis,
    so the trajectory is the per-model loop's exactly."""

    def __init__(self, fed, registry, n_clients, train_fn, acc_fn,
                 device: torch.device):
        super().__init__(fed, registry, n_clients, device)
        self._round = make_llm_round(train_fn, acc_fn)
        self._eval = make_llm_eval(acc_fn)
        self._readers: Optional[Tuple[Callable, Optional[Callable]]] = None

    def launch(self, plan: RoundPlan) -> None:
        tokens, labels, vt, vl = self._batches
        bank = self.registry.params
        models, weights = self._train_sets(plan)
        eval_rows = [bank.row_of[m] for m in plan.live]
        if models:
            rows = [bank.row_of[m] for m in models]
            w = to_device(np.stack(weights), np.float32, self.device)
            losses, mat = self._round(bank.tree, rows, w, tokens, labels,
                                      vt, vl, eval_rows)
            loss_reader: Optional[Callable] = _host_async(losses)
        else:
            mat = self._eval(bank.tree, eval_rows, vt, vl)
            loss_reader = None
        self._readers = (_host_async(mat), loss_reader)
        self._pending = plan

    def readback(self) -> RoundResult:
        plan = self._pending
        mat_reader, loss_reader = self._readers
        self._readers = None
        mat = mat_reader()
        self.round_losses = ([float(x) for x in loss_reader()]
                             if loss_reader is not None else [])
        accs = np.zeros((self.n_devices, self.cfg.max_models))
        for j, m in enumerate(plan.live):
            accs[:, m] = mat[j]
        self._result = RoundResult(accs)
        return super().readback()
