"""Cluster-shared draft models for speculative decoding (port of
``repro/serve/draft.py``; DESIGN.md §16).

FedCD's clone/delete population means every live model is one cluster's
preferred model — so one small draft per cluster is the natural unit.
Drafts here are truncated-depth siblings: the leading ``draft_layers``
layers of the target (weights SHARED by construction — a layer-sliced
view of the target's own rows, re-derived each round), plus the target's
embedding/final-norm/head. That keeps the draft's vocabulary and
residual geometry identical to the target's, which is what acceptance
rate lives on, and makes "training" the draft free: refreshing the
truncation after each federated round IS the draft update.

Truncation of the port's flat layout: ``segments.{i}.*`` ``(L, ...)``
keep their leading rows; the hybrid's ``mamba_groups.*`` ``(sites,
every, ...)`` and ``lora.*`` ``(sites, ...)`` their first sites,
``mamba_tail.*`` its first tail layers; ``shared.*``, ``embed.*``,
``final_norm.*`` and ``lm_head`` are kept whole; the MTP head is dropped.

:class:`DraftBank` mirrors the registry's :class:`~repro_torch.core.
registry.StackedParamBank` row layout (same ``row_of`` indices), so the
gateway reads draft rows as views ``tree[k][row]``, as it reads target
rows. Rows are population state: refreshed IN PLACE per round,
snapshotted/restored with the trainer checkpoint, and released when
their cluster's target is deleted.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Set, Tuple

import torch

from repro_torch.config import ArchConfig
from repro_torch.models import transformer as tf
from repro_torch.models.common import Params, canonical


def draft_depth(cfg: ArchConfig, draft_layers: int) -> int:
    """The effective draft depth for ``cfg``: ``draft_layers`` clamped
    to the target's depth and, for the hybrid family, snapped so the
    truncation maps onto whole shared-attention sites (a site = ``every``
    mamba layers + the shared block) plus at most the target's own tail.
    """
    if draft_layers <= 0:
        raise ValueError(f"draft_layers must be positive: {draft_layers}")
    d = min(draft_layers, cfg.n_layers)
    if cfg.family != "hybrid":
        return d
    every = cfg.shared_attn_every
    n_sites = cfg.n_layers // every
    n_tail = cfg.n_layers - n_sites * every
    d_sites = max(1, min(d // every, n_sites))
    d_tail = min(max(d - d_sites * every, 0), n_tail)
    return d_sites * every + d_tail


def draft_config(cfg: ArchConfig, draft_layers: int) -> ArchConfig:
    """The truncated-depth sibling's config: same family/width/vocab,
    ``draft_depth`` layers, layout equal to ``cfg.layout()`` truncated —
    so a draft cache is a plain ``init_lm_caches(draft_config(...))``
    and the draft params are leading-row slices of the target's."""
    d = draft_depth(cfg, draft_layers)
    kw: dict = {"n_layers": d, "mtp": False}
    if cfg.family == "ssm":
        sl = tuple(i for i in cfg.xlstm.slstm_layers if i < d)
        kw["xlstm"] = dataclasses.replace(cfg.xlstm, slstm_layers=sl)
    dcfg = dataclasses.replace(cfg, **kw)
    assert dcfg.layout() == cfg.layout()[:d], \
        "draft layout is not a prefix of the target layout"
    return dcfg


def truncate_lm_params(cfg: ArchConfig, dcfg: ArchConfig,
                       params: Params) -> Params:
    """Slice a target param dict down to its draft (module docstring):
    pure slicing — every leaf a VIEW of ``params``' — so the draft is
    exactly the target's own lower stack."""
    out: Params = {}
    if cfg.family == "hybrid":
        n_sites_d, every, _ = tf.hybrid_sites(dcfg)
        n_tail_d = dcfg.n_layers - n_sites_d * every
        rows = {"mamba_groups.": n_sites_d, "lora.": n_sites_d,
                "mamba_tail.": n_tail_d, "shared.": None}
    else:
        rows, remaining = {}, dcfg.n_layers
        for i, (_kind, n) in enumerate(tf.segments(cfg)):
            rows[f"segments.{i}."] = min(n, remaining)
            remaining -= rows[f"segments.{i}."]
    for k, v in params.items():
        if k.startswith(("embed.", "final_norm.")) or k == "lm_head":
            out[k] = v
            continue
        take = next((n for p, n in rows.items() if k.startswith(p)), 0)
        if take is None:
            out[k] = v                        # the shared block, whole
        elif take > 0:
            out[k] = v[:take]
    return canonical(out)


class DraftBank:
    """Stacked draft rows mirroring the target bank's row layout.

    ``tree`` holds ``m_cap`` draft rows; a live model's draft sits at
    the SAME row index the target bank's ``row_of`` maps it to, so one
    host row index serves both. ``refresh`` re-derives every live draft
    from the current target rows (per-round draft "training"), pre-warms
    clones the moment their row lands (genealogy for free — a clone's row
    IS the parent's weights until it diverges), and releases drafts of
    deleted models.

    ``template``: one target model's params (a bank row's views or a
    dict entry): the draft rows take their shapes, dtypes and device
    from its truncation, so no second model is initialised.
    """

    def __init__(self, cfg: ArchConfig, draft_layers: int, m_cap: int,
                 template: Params):
        self.cfg = cfg
        self.draft_layers = draft_layers
        self.dcfg = draft_config(cfg, draft_layers)
        self.m_cap = m_cap
        one = truncate_lm_params(cfg, self.dcfg, template)
        self.tree: Params = {
            k: torch.zeros((m_cap,) + tuple(v.shape), dtype=v.dtype,
                           device=v.device) for k, v in one.items()}
        self.present: Set[int] = set()
        self.refreshed = 0
        self.released = 0

    @staticmethod
    def _row_of(bank: Any, m: int) -> int:
        row_of = getattr(bank, "row_of", None)
        return row_of[m] if row_of is not None else m

    def row(self, registry: Any, m: int) -> int:
        return self._row_of(registry.params, m)

    def row_params(self, r: int) -> Params:
        """Row ``r``'s draft params, as views."""
        return {k: v[r] for k, v in self.tree.items()}

    @torch.no_grad()
    def refresh(self, registry: Any,
                params_of: Optional[Any] = None
                ) -> Tuple[List[int], List[int]]:
        """Reconcile drafts with the live population: re-truncate every
        live model's row in place, drop dead models'. ``params_of(m)``
        overrides how target params are read (the trainer passes its
        executor's accessor). Returns (added_ids, dropped_ids)."""
        bank = registry.params
        live = set(registry.live_ids())
        dropped = sorted(self.present - live)
        for m in dropped:
            self.present.discard(m)
            self.released += 1
        added = sorted(live - self.present)
        for m in sorted(live):
            src = params_of(m) if params_of is not None else bank[m]
            row = truncate_lm_params(self.cfg, self.dcfg, src)
            dst = self.row_params(self._row_of(bank, m))
            for k, v in row.items():
                dst[k].copy_(v)
            self.present.add(m)
            self.refreshed += 1
        return added, dropped

    def nbytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in self.tree.values())
