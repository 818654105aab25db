"""Placement of the stacked banks on the launch mesh (port of the bank
half of ``repro/launch/sharding.py:160-237``).

The reference describes placement with ``NamedSharding``s
(``bank_shardings``, ``data_bank_shardings``) and lets XLA place the
blocks. The port places them itself: model shard ``sm``'s block of bank
rows lives on its owner cell ``(sm, 0)``, data shard ``sd``'s block of
device rows on ``(0, sd)``, and a cell on another device reads a copy
(:class:`Replicas`) that is refreshed when the owner's block changes.
Where the cells share a device the owner's tensors serve them all and no
copy is ever made.

The LM half (``param_spec``, ``param_shardings``, ``auto_shardings``,
``lm_bank_shardings``, ``batch_spec``, ``replicated``: the reference's
``:27-158``, ``:180-195``, ``:239-248``) describes the tensor-parallel LM
layout (megatron-style FSDP x TP; dp = the data axes, tp = ``model``):

* column-parallel 2D weights (qkv, mlp-in, ...):  P(dp, tp)
* row-parallel 2D weights (wo, w_down, ...):      P(tp, dp)
* expert tensors (E, d, f):                       E over tp
* embed (V, d): V over tp;  lm_head (d, V): V over tp
* norms / small vectors / router: replicated
* stacked layer dims are never sharded

:class:`PartitionSpec` and :class:`NamedSharding` stand in for JAX's: a
spec is a tuple whose entries are ``None``, an axis name or a tuple of
axis names (a one-name tuple reads as the name, as JAX normalizes it),
and a sharding pairs it with a :class:`LaunchMesh`. The rules run on the
reference's ``/``-joined leaf path (the port's flat ``.`` name with
``/``), so its tag quirks carry over unchanged, and so does the
divisibility re-check of :func:`param_shardings`. The runtime that lays
leaves out by these specs is ``launch/tensor_parallel.py``.

Decoder caches on the mesh are laid out by the port's own
:func:`cache_shardings`, not by the reference's :func:`auto_shardings`.
The latter is a placement rule for XLA's partitioner: on the keys
``0.k`` / ``0.v`` ``(L, B, C, Kv, hd)``, which carry no stack tag, it
puts ``data`` on the layer axis where ``L`` divides and ``model`` on
``hd``, cutting every head in half. The port's cells compute whole heads
(``attention.heads_per_cell``), so that layout would gather every cache
at every token. :func:`cache_shardings` puts ``Kv`` on ``model`` where
the attention heads split, the batch on the data-parallel axes where the
rows split, and replicates everything else. Both are placements only:
the values are the same. :func:`auto_shardings` stays as ported and
spec-equal to the reference's; the port's dry run (``launch/dryrun.py``)
lays caches out by :func:`cache_shardings`, the layout the port runs.

On a multi-pod mesh ``dp = ("pod", "data")``: every data-parallel entry
is that combined entry, which the runtime reads as one data axis over
the flat data-parallel index (``launch/mesh.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from itertools import groupby
from typing import Any, Dict, Hashable, List, Sequence, Tuple

import torch

from repro_torch import config as C
from repro_torch.config import ArchConfig
from repro_torch.launch.mesh import (LaunchMesh, data_axis_size, dp_axes_of,
                                     dp_size, model_axis_size)


def bank_rows_per_shard(m_cap: int, mesh: LaunchMesh) -> int:
    """Rows each model-axis shard owns; row ``m`` lives on shard
    ``m // rows_per_shard`` (a contiguous block)."""
    n = model_axis_size(mesh)
    if m_cap % n != 0:
        raise ValueError(
            f"max_models={m_cap} must divide evenly over the mesh's "
            f"model axis ({n} shards)")
    return m_cap // n


def data_rows_per_shard(n_cap: int, mesh: LaunchMesh) -> int:
    """Data-bank rows each ``data``-axis shard owns; row ``r`` lives on
    shard ``r // rows_per_shard``. ``DeviceDataBank`` rounds its capacity
    up to a multiple of the data axis before calling this, so the
    divisibility error only fires on hand-built layouts."""
    n = data_axis_size(mesh)
    if n_cap % n != 0:
        raise ValueError(
            f"data bank capacity={n_cap} must divide evenly over the "
            f"mesh's data axis ({n} shards)")
    return n_cap // n


def bank_devices(mesh: LaunchMesh) -> List[torch.device]:
    """The owner device of each model shard's bank block (the stand-in
    for ``bank_shardings``): cell ``(sm, 0)``."""
    return [mesh.device(sm, 0) for sm in range(model_axis_size(mesh))]


def data_bank_devices(mesh: LaunchMesh) -> List[torch.device]:
    """The owner device of each data shard's block of device rows (the
    stand-in for ``data_bank_shardings``): cell ``(0, sd)``."""
    return [mesh.device(0, sd) for sd in range(data_axis_size(mesh))]


class Replicas:
    """Copies of owner blocks on other devices. ``get(key, stamp,
    tensors, device)`` returns ``tensors`` themselves when they already
    live on ``device``; otherwise a copy on ``device``, made anew
    whenever the owner's ``stamp`` for ``key`` moved since the last copy.
    Each copy is a non-blocking device-to-device transfer ordered after
    the owner's writes on its stream."""

    def __init__(self):
        self._copies: Dict[Tuple[Hashable, torch.device],
                           Tuple[Any, Dict[str, torch.Tensor]]] = {}

    def get(self, key: Hashable, stamp: Any,
            tensors: Dict[str, torch.Tensor],
            device: torch.device) -> Dict[str, torch.Tensor]:
        if next(iter(tensors.values())).device == device:
            return tensors
        hit = self._copies.get((key, device))
        if hit is None or hit[0] != stamp:
            hit = (stamp, {k: v.to(device, non_blocking=True)
                           for k, v in tensors.items()})
            self._copies[(key, device)] = hit
        return hit[1]

    def clear(self) -> None:
        self._copies.clear()


# -- the LM half: tensor-parallel specs ---------------------------------------

class PartitionSpec(tuple):
    """A spec over a leaf's dims: each entry ``None``, an axis name or a
    tuple of axis names (a one-name tuple is stored as the name)."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(
            p[0] if isinstance(p, tuple) and len(p) == 1 else
            (tuple(p) if isinstance(p, (tuple, list)) else p)
            for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclass(frozen=True)
class NamedSharding:
    """A spec laid over a launch mesh."""
    mesh: LaunchMesh
    spec: PartitionSpec


ROW_PARALLEL = {"wo", "w_down", "w_out", "w_ff2", "fc2", "ob", "cb", "qb"}
REPLICATED = {"scale", "bias", "A_log", "D", "dt_bias", "f_bias", "conv_b",
              "router", "pos", "index"}
ATTN_WEIGHTS = {"wq", "wk", "wv", "wo", "wq_a", "wq_b", "wkv_a", "wk_b",
                "wv_b"}


def _n_stack_dims(path: str) -> int:
    if "mamba_groups" in path:
        return 2
    for tag in ("segments", "mamba_tail", "lora", "enc_blocks", "dec_blocks",
                "groups", "tail", "shared/", "self/", "cross/"):
        if path.startswith(tag) or f"/{tag}" in path or path.startswith(
                tag.rstrip("/")):
            return 1
    return 0


def leaf_path(name: str) -> str:
    """The reference's ``/``-joined pytree path of the port's flat name."""
    return name.replace(".", "/")


def _shape_of(leaf: Any) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def param_spec(cfg: ArchConfig, path: str, shape: Tuple[int, ...],
               dp: Tuple[str, ...], tp: str, tp_size: int,
               policy: str = "train") -> PartitionSpec:
    """Sharding spec for one parameter leaf (shape EXCLUDES stack dims)."""
    name = path.split("/")[-1]
    nd = len(shape)
    if name in REPLICATED or nd <= 1:
        return P(*([None] * nd))
    if policy == "decode_2d" and nd == 2 and name not in ATTN_WEIGHTS:
        # decode: weights never move, 2D tensor-parallel over both axes
        dpm = tuple([*dp, tp])
        if name == "table":
            return P(dpm, None)
        if name == "lm_head":
            return P(None, dpm)
        if name in ROW_PARALLEL:
            return P(dpm, None)
        return P(None, dpm)
    if name == "table":                      # embedding (V, d): vocab-parallel
        return P(tp, None)
    if name == "lm_head":
        return P(None, tp)
    if "moe" in path and nd == 3:            # (E, d, f) expert-parallel
        if name in ("w_gate", "w_up"):
            return P(tp, dp, None)
        return P(tp, None, dp)               # w_down (E, f, d)
    if name == "conv_w":                     # (W, D) depthwise
        return P(None, tp) if shape[1] % tp_size == 0 else P(None, None)
    if name == "r" and nd == 4:              # slstm recurrent (4, H, dh, dh)
        return P(None, None, None, None)
    if nd == 2:
        # divisibility is re-validated against the axis sizes by
        # param_shardings
        if name in ROW_PARALLEL:
            return P(tp, dp)
        return P(dp, tp)
    return P(*([None] * nd))


def leaf_sharding(cfg: ArchConfig, name: str, shape: Tuple[int, ...],
                   mesh: LaunchMesh, policy: str = "train"
                   ) -> NamedSharding:
    """The sharding of one leaf ``name`` of ``shape`` (stack dims
    included) under the rules of :func:`param_shardings`."""
    dp = dp_axes_of(mesh)
    dpn = dp_size(mesh)
    tp = "model" if "model" in mesh.axis_names else None
    tpn = mesh.shape.get("model", 1)
    ps = leaf_path(name)
    nstack = min(_n_stack_dims(ps), max(len(shape) - 1, 0))
    inner = shape[nstack:]
    spec = param_spec(cfg, ps, inner, dp, tp, tpn, policy)
    # re-validate divisibility against the axis sizes (the reference's
    # comparison, verbatim: a one-axis dp entry reads as its name there,
    # so it is checked against the model axis's size)
    fixed = []
    for dim, s in zip(inner, spec):
        if s is None:
            fixed.append(None)
        else:
            size = (dpn if s == dp else
                    dpn * tpn if isinstance(s, tuple) and tp in s else
                    tpn)
            fixed.append(s if dim % size == 0 else None)
    return NamedSharding(mesh, P(*([None] * nstack + fixed)))


def param_shardings(cfg: ArchConfig, params_shape: Dict[str, Any],
                    mesh: LaunchMesh, policy: str = "train"
                    ) -> Dict[str, NamedSharding]:
    """``{name: NamedSharding}`` for a flat param dict (tensors, meta
    tensors, or shapes) of ``init_lm`` / ``init_encdec``."""
    return {k: leaf_sharding(cfg, k, _shape_of(v), mesh, policy)
            for k, v in params_shape.items()}


def auto_shardings(tree_shape: Dict[str, Any], mesh: LaunchMesh,
                   skip_leading: int = 1, batch_dim_first: bool = True
                   ) -> Dict[str, NamedSharding]:
    """Generic rule for caches/states: dp on the first divisible dim
    (usually batch), tp on the last remaining divisible dim."""
    dp = dp_axes_of(mesh)
    dpn = dp_size(mesh)
    tpn = mesh.shape.get("model", 1)

    def spec_for(name, leaf):
        shape = _shape_of(leaf)
        ps = leaf_path(name)
        nd = len(shape)
        nstack = min(_n_stack_dims(ps), max(nd - 1, 0))
        spec: List[Any] = [None] * nd
        if ps.split("/")[-1] in ("pos", "index") or nd - nstack < 1:
            return NamedSharding(mesh, P(*spec))
        dims = list(range(nstack, nd))
        used = set()
        if batch_dim_first and dims:
            b = dims[0]
            if shape[b] % dpn == 0 and shape[b] > 1:
                spec[b] = dp
                used.add(b)
        for d in reversed(dims):
            if d in used:
                continue
            if shape[d] % tpn == 0 and shape[d] >= tpn:
                spec[d] = "model"
                break
        return NamedSharding(mesh, P(*spec))

    return {k: spec_for(k, v) for k, v in tree_shape.items()}


def heads_split(cfg: ArchConfig, tp: int) -> bool:
    """Whether a GQA block's heads split over ``tp`` model cells (under
    the 'train' specs, whose ``wq`` / ``wk`` / ``wv`` / ``wo`` split
    exactly when the heads and the KV heads divide)."""
    return cfg.n_heads % tp == 0 and cfg.n_kv_heads % tp == 0


def cache_shardings(cfg: ArchConfig, caches: Dict[str, Any],
                    mesh: LaunchMesh,
                    dp_axes: Sequence[str] = ("data",)
                    ) -> Dict[str, NamedSharding]:
    """The port's layout of ``init_lm_caches(cfg, ...)`` on ``mesh``
    (module docstring): ``k`` / ``v`` of a GQA segment keep their KV
    heads on ``model`` where the heads split (the hybrid's shared block
    runs gathered, MLA's latents have no head axis); every leaf but
    ``index`` / ``pos`` keeps its batch on the data-parallel axes
    (``("data",)``, or ``("pod", "data")`` on a multi-pod mesh) where the
    rows split over them (the batch divides; ``dp_axes`` names them, as
    the mesh runtime's ``MeshRun``)."""
    kinds = [k for k, _ in groupby(cfg.layout())]
    tpn = mesh.shape["model"]
    dp = tuple(a for a in dp_axes if a in mesh.axis_names)
    dpn = dp_size(mesh) if dp else 1

    def spec_for(name, leaf):
        shape = _shape_of(leaf)
        prefix, _, leaf_name = name.rpartition(".")
        nstack = 2 if name.startswith("groups.") else 1
        spec: List[Any] = [None] * len(shape)
        if leaf_name in ("index", "pos") or len(shape) <= nstack:
            return NamedSharding(mesh, P(*spec))
        if dpn > 1 and shape[nstack] % dpn == 0:
            spec[nstack] = dp
        if (cfg.family != "hybrid" and leaf_name in ("k", "v")
                and kinds[int(prefix)] in (C.ATTN_MLP, C.ATTN_MOE)
                and heads_split(cfg, tpn)):
            spec[nstack + 2] = "model"
        return NamedSharding(mesh, P(*spec))

    return {k: spec_for(k, v) for k, v in caches.items()}


def lm_bank_shardings(cfg: ArchConfig, template: Dict[str, Any],
                      mesh: LaunchMesh, policy: str = "train"
                      ) -> Dict[str, NamedSharding]:
    """Shardings of a per-layer-stacked LM bank: each leaf's
    ``(max_models,) + leaf.shape`` tensor keeps the row axis REPLICATED
    and composes :func:`param_shardings`' specs on the inner dims, so
    every cell keeps all rows of its piece."""
    return {k: NamedSharding(mesh, P(None, *s.spec))
            for k, s in param_shardings(cfg, template, mesh,
                                        policy).items()}


def batch_spec(mesh: LaunchMesh, batch: int, ndim: int) -> NamedSharding:
    """Activation/input sharding: batch over dp when divisible."""
    dp = dp_axes_of(mesh)
    lead = dp if batch % dp_size(mesh) == 0 else None
    return NamedSharding(mesh, P(lead, *([None] * (ndim - 1))))


def replicated(mesh: LaunchMesh, ndim: int = 0) -> NamedSharding:
    return NamedSharding(mesh, P(*([None] * ndim)))
