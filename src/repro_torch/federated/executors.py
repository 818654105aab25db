"""Device-side round executors: the data-plane half of a federated round
(port of the synchronous fused executors of
``repro/federated/executors.py``).

A :class:`RoundExecutor` turns one host-built
:class:`~repro_torch.core.plan.RoundPlan` into device work and owns the
eval-row caches and the test-row prediction. The contract:

    plan_hints()  -> what the executor can reuse bit-identically
    launch(plan)  -> enqueue the round's device work
    readback()    -> wait for the eval matrices, return RoundResult
    collect(pref) -> the round's preferred-model test/val accuracies
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import FedCDConfig
from repro_torch.core.plan import EvalHints, RoundPlan
from repro_torch.core.registry import ModelRegistry
from repro_torch.data.bank import DeviceDataBank
from repro_torch.federated.simulation import (make_fused_eval,
                                              make_fused_round,
                                              pad_live_rows, pad_work_batch)


@dataclass
class RoundResult:
    """What the control plane needs back from one dispatched round."""
    accs: np.ndarray                     # (N, M_cap) val accuracies


@dataclass
class TrainMeta:
    """Which (model, device) pairs a train batch covers, in bucket-column
    order; ``b_pad`` is the padded batch width."""
    pair_model: List[int]
    pair_device: List[int]
    b_pad: int


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class RoundExecutor:
    """Shared scaffolding; engines override the dispatch internals."""

    def __init__(self, cfg: FedCDConfig, registry: ModelRegistry,
                 databank: DeviceDataBank):
        self.cfg = cfg
        self.registry = registry
        self.databank = databank
        self.n_devices = databank.n_devices

    def plan_hints(self) -> Optional[EvalHints]:
        return None                      # no bit-identical reuse

    def launch(self, plan: RoundPlan) -> None:
        raise NotImplementedError

    def readback(self) -> RoundResult:
        raise NotImplementedError

    def on_clones(self, cloned: List[Tuple[int, int]]) -> None:
        pass

    def collect(self, preferred: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError


class FusedExecutor(RoundExecutor):
    """The device-resident data plane: params live in the registry's
    stacked bank and the synchronous round is ONE ``make_fused_round``
    call that updates the bank in place. Owns the per-model eval-row
    caches and the test-row prediction."""

    def __init__(self, cfg, registry, databank, loss_fn, acc_fn):
        super().__init__(cfg, registry, databank)
        self._round = make_fused_round(loss_fn, acc_fn, cfg.lr,
                                       cfg.quantize_bits)
        self._eval = make_fused_eval(acc_fn)
        # eval-row caches: a model's params change ONLY when it trains or
        # is born, so its (N,) accuracy rows are reused until then
        self._val_cache: Dict[int, np.ndarray] = {}
        self._test_cache: Dict[int, np.ndarray] = {}
        self._pred_rows: List[int] = [0]
        self._needs_refresh = False
        self._pending: Optional[Tuple[RoundPlan, Dict[str, Callable]]] = \
            None

    @property
    def _dev(self) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        return self.databank.splits

    # -- planning hints + lifecycle hooks ---------------------------------
    def plan_hints(self) -> EvalHints:
        return EvalHints(set(self._val_cache), set(self._test_cache),
                         list(self._pred_rows))

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
        META's pair columns."""
        agg_rows = pad_live_rows(plan.agg_models)
        slot = {m: j for j, m in enumerate(plan.agg_models)}
        w = np.zeros((len(agg_rows), meta.b_pad), np.float32)
        for k, (m, d) in enumerate(zip(meta.pair_model, meta.pair_device)):
            j = slot.get(m)
            if j is not None:
                w[j, k] = plan.scores[d, m]
        w[len(plan.agg_models):] = w[0]
        return w, agg_rows

    def _batch_args(self, pair_model: List[int], pair_device: List[int],
                    perms: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                               TrainMeta]:
        m_idx, d_idx, pperms = pad_work_batch(
            pair_model, pair_device, [perms[d] for d in pair_device])
        meta = TrainMeta(list(pair_model), list(pair_device), len(m_idx))
        return m_idx, d_idx, pperms, meta

    # -- eval dispatch / readers ------------------------------------------
    @staticmethod
    def _val_reader_dense(mat: torch.Tensor, models: List[int]
                          ) -> Callable:
        def read() -> Dict[int, np.ndarray]:
            rows = _host(mat)[:len(models)]
            return {m: rows[j] for j, m in enumerate(models)}
        return read

    def _dispatch_dense(self, models: List[int], split: str) -> Callable:
        mat = self._eval(self.registry.params.tree, pad_live_rows(models),
                         *self._dev[split])
        return self._val_reader_dense(mat, models)

    def _dispatch_evals(self, plan: RoundPlan) -> Dict[str, Callable]:
        pend: Dict[str, Callable] = {}
        if plan.val_stale:
            pend["val"] = self._dispatch_dense(plan.val_stale, "val")
        if plan.test_stale:
            pend["test"] = self._dispatch_dense(plan.test_stale, "test")
        return pend

    # -- launch -----------------------------------------------------------
    def launch(self, plan: RoundPlan) -> None:
        bank = self.registry.params
        if plan.pair_model:
            # the whole round as ONE call
            m_idx, d_idx, pperms, meta = self._batch_args(
                plan.pair_model, plan.pair_device, plan.perms)
            w, agg_rows = self._apply_weights(meta, plan)
            val_mat, test_mat = self._round(
                bank.tree, m_idx, d_idx, pperms, w, agg_rows,
                pad_live_rows(plan.val_stale or plan.live[:1]),
                pad_live_rows(plan.test_stale or plan.live[:1]),
                *self._dev["train"], *self._dev["val"], *self._dev["test"])
            pend: Dict[str, Callable] = {}
            if plan.val_stale:
                pend["val"] = self._val_reader_dense(val_mat, plan.val_stale)
            if plan.test_stale:
                pend["test"] = self._val_reader_dense(test_mat,
                                                      plan.test_stale)
        else:
            pend = self._dispatch_evals(plan)      # no pairs: eval only
        self._pending = (plan, pend)

    # -- readback + collect -----------------------------------------------
    def readback(self) -> RoundResult:
        plan, pend = self._pending
        self._pending = None
        if "val" in pend:
            self._val_cache.update(pend["val"]())
        if "test" in pend:
            self._test_cache.update(pend["test"]())
        # a changed model's old test row is stale: drop it unless it was
        # just re-evaluated
        for m in plan.changed_models():
            if m not in plan.test_stale:
                self._test_cache.pop(m, None)
        accs = np.zeros((self.n_devices, self.cfg.max_models))
        for m in plan.live:
            accs[:, m] = self._val_cache[m]
        return RoundResult(accs)

    def eval_rows(self, rows: List[int], split: str) -> np.ndarray:
        """(len(rows), N) accuracy of the given models on one split."""
        mat = self._eval(self.registry.params.tree, pad_live_rows(rows),
                         *self._dev[split])
        return _host(mat)[:len(rows)]

    def _refresh_caches(self) -> None:
        """Quantized cloning made every clone's params differ from its
        parent's: re-score the whole live population once."""
        live = self.registry.live_ids()
        if not live:
            self._val_cache, self._test_cache = {}, {}
            return
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
        usable = [m if (m in entries and entries[m].alive
                        and m in self._val_cache
                        and i in self.databank) else None
                  for i, m in enumerate(wanted)]
        missing = sorted({m for m in usable
                          if m is not None and m not in self._test_cache})
        if missing:
            # test-row prediction missed (a preference shifted to a model
            # that didn't train): one small dense eval
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


# -- FedAvg executor ----------------------------------------------------------

@dataclass
class FedAvgResult:
    val_acc: np.ndarray                  # (N,)
    test_acc: np.ndarray                 # (N,)


class FedAvgFusedExecutor:
    """Device-resident FedAvg: the global model is row 0 of a (1, ...)
    bank and the synchronous round is one ``make_fused_round`` call with
    one-row buckets, updating the bank in place."""

    def __init__(self, cfg: FedCDConfig, databank: DeviceDataBank,
                 init_params: Dict[str, torch.Tensor], loss_fn, acc_fn):
        self.cfg = cfg
        self.databank = databank
        self.n_devices = databank.n_devices
        self._stacked = {k: v[None].clone() for k, v in init_params.items()}
        self._round = make_fused_round(loss_fn, acc_fn, cfg.lr)
        self._pending: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def get_params(self) -> Dict[str, torch.Tensor]:
        return {k: v[0] for k, v in self._stacked.items()}

    def set_params(self, value: Dict[str, torch.Tensor]) -> None:
        for k, v in self._stacked.items():
            v[0].copy_(torch.as_tensor(value[k]))

    def launch(self, plan: RoundPlan) -> None:
        d_ids = plan.pair_device
        b = len(d_ids)
        m_idx, d_idx, pp = pad_work_batch(
            [0] * b, list(d_ids), [plan.perms[d] for d in d_ids])
        w = np.zeros((1, len(m_idx)), np.float32)
        w[0, :b] = plan.scores[np.asarray(d_ids, np.int64), 0]
        row = np.zeros(1, np.int32)
        splits = self.databank.splits
        self._pending = self._round(
            self._stacked, m_idx, d_idx, pp, w, row, row, row,
            *splits["train"], *splits["val"], *splits["test"])

    def readback(self) -> FedAvgResult:
        val_mat, test_mat = self._pending
        self._pending = None
        return FedAvgResult(val_acc=_host(val_mat)[0],
                            test_acc=_host(test_mat)[0])
