"""Elastic checkpoint/resume: the complete logical round state (port of
``repro/checkpoint/state.py``: the ``fedcd``, ``fedavg`` and ``fedllm``
kinds, the last with the serving plane's draft rows).

``checkpoint/io.py`` snapshots one tree; this module snapshots a RUNNING
SERVER — everything the next round depends on, keyed by the control
plane's stable ids, never by layout:

* param bank rows keyed by model *id*, plus the placement maps;
* data bank splits keyed by device *id* (under churn only: joined and
  drifted devices' data is not re-derivable without replaying the churn
  stream);
* registry genealogy, score state, presence mask;
* every host RNG stream position (sampling, lifecycle noise, churn
  cursor) via ``Generator.bit_generator.state``;
* the sampling prefetch (round t+1's sample is drawn before round t
  ends — the saved RNG state is already past it);
* the semi-sync coordinator's clock, straggler buffer, aggregation mass
  and stats, plus the executor's harvested stale updates;
* the executor's eval-row caches and test-row prediction (so the resumed
  run plans the identical stale sets);
* the per-round metrics history.

The format is the reference's, key for key and dtype for dtype: a
checkpoint either package writes resumes in the other. The port's labels
(int64 on the device) are written as the reference's int32.

**Commit ordering** (crash consistency): ``arrays.npz`` is written via
tmp + ``os.replace``, then ``manifest.json`` — carrying per-array
crc32/dtype/shape — commits LAST. A checkpoint without a readable,
matching manifest does not exist; a crash mid-save therefore leaves the
previous step intact and the torn step invisible to
:func:`latest_checkpoint`.

**Resharding-on-resume**: restore targets whatever mesh shape the NEW
server was built with. When the shard layout matches the checkpoint's,
placement (``row_of``, used rows, load EWMA) restores verbatim and the
resumed run is bit-identical to the uninterrupted one; otherwise ids
re-place through the banks' least-loaded allocators and the runs agree
in discrete state with params equal to reduction order. A
tensor-parallel LM bank (``FedLLMTrainer(mesh=...)``) snapshots each row
gathered into whole leaves, in the reference's format; a restore splits
them onto the new bank by its ``lm_bank_shardings``, so a checkpoint
crosses meshes as it crosses packages.

**Device state.** A snapshot is a barrier: it copies the banks, the
stale updates and (under churn) the data rows to the host, waiting for
the card. Restore writes every row IN PLACE into the server's existing
bank tensors through pinned memory (the executors keep reading those
tensors) and moves both banks' ``version`` on. Pipelined executors
quiesce (drop the in-flight speculation) before the snapshot: the
resumed round then trains synchronously and computes identical params.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.checkpoint.io import (CheckpointError, _crc,
                                       _flatten_with_paths, _host_array,
                                       atomic_savez, atomic_write_bytes,
                                       atomic_write_json)
from repro_torch.config import to_dict
from repro_torch.core.registry import StackedParamBank
from repro_torch.federated.simulation import to_device
from repro_torch.launch.tensor_parallel import Sharded

SCHEMA = 1
ARRAYS = "arrays.npz"
MANIFEST = "manifest.json"
LATEST = "LATEST"

Template = Dict[str, torch.Tensor]   # param name -> meta tensor (shape, dtype)


# -- tree <-> flat-key helpers ----------------------------------------------

def _flatten(prefix: str, tree: Any) -> Dict[str, np.ndarray]:
    return {f"{prefix}/{k}": v
            for k, v in _flatten_with_paths(tree).items()}


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The host dtype a leaf of ``dtype`` travels as (numpy has no
    bfloat16; its float32 widening is exact and casts back on the
    device)."""
    if dtype == torch.bfloat16:
        return np.dtype(np.float32)
    return torch.empty((), dtype=dtype).numpy().dtype


def _unflatten(template: Template, arrays: Dict[str, np.ndarray],
               prefix: str) -> Dict[str, np.ndarray]:
    """One model's host rows from ``{prefix}/...`` keys, each cast to the
    template leaf's host dtype."""
    out = {}
    for name, leaf in template.items():
        key = f"{prefix}/{name.replace('.', '/')}"
        if key not in arrays:
            raise CheckpointError(f"checkpoint missing array {key!r}")
        out[name] = np.asarray(arrays[key], _numpy_dtype(leaf.dtype))
    return out


def _to_server(host: Dict[str, np.ndarray], template: Template,
               device: torch.device) -> Dict[str, torch.Tensor]:
    """Host rows -> new tensors of the template's dtypes on ``device``,
    through pinned memory."""
    return {k: to_device(a, a.dtype, device).to(template[k].dtype)
            for k, a in host.items()}


def _rng_state(gen: Optional[np.random.Generator]) -> Optional[dict]:
    return None if gen is None else gen.bit_generator.state


def _set_rng(gen: np.random.Generator, state: dict) -> None:
    gen.bit_generator.state = state


def _kind(server: Any) -> str:
    """Duck-typed dispatch, as in the reference: FedLLMTrainer carries a
    client count (checked FIRST — it carries a planner too), FedCDServer
    a planner, FedAvgServer neither."""
    if hasattr(server, "n_clients"):
        return "fedllm"
    return "fedcd" if hasattr(server, "planner") else "fedavg"


def _config(server: Any) -> dict:
    return to_dict(server.cfg) if hasattr(server, "cfg") else \
        to_dict(server.fed)


def _param_template(server: Any) -> Template:
    """One model's param shapes and dtypes (restore casts every saved
    array back through it)."""
    if _kind(server) == "fedavg":
        src = server.executor.get_params()
    elif isinstance(server.registry.params, StackedParamBank):
        src = {k: v[0] for k, v in server.registry.params.block(0).items()}
    else:
        src = server.registry.params[server.registry.live_ids()[0]]
    return {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in src.items()}


def _databank(server: Any) -> Any:
    """The server's data bank as the reference's checkpoints see it: the
    legacy and batched engines hold their data in the reference's dict
    form, with no bank (and no churn)."""
    return server.databank if server.engine == "fused" else None


# -- snapshot assembly -------------------------------------------------------

def _snapshot_scores(arrays: dict, state: Any) -> None:
    arrays["score/history"] = np.asarray(state.history)
    arrays["score/active"] = np.asarray(state.active)
    arrays["score/alive"] = np.asarray(state.alive)


def _snapshot_params(arrays: dict, scalars: dict, registry: Any) -> None:
    stacked = isinstance(registry.params, StackedParamBank)
    scalars["stacked"] = stacked
    for m in registry.live_ids():
        # a tensor-parallel bank's row: its pieces gathered whole
        row = {k: v.full(v.device) if isinstance(v, Sharded) else v
               for k, v in registry.params[m].items()}
        arrays.update(_flatten(f"params/{m}", row))
    if stacked:
        pb = registry.params
        scalars["bank"] = {
            "n_shards": pb.n_shards,
            "rows_per_shard": pb.rows_per_shard,
            "row_of": {str(m): r for m, r in pb.row_of.items()},
            "used_rows": sorted(pb._used_rows),
            "load_ewma": [float(v) for v in pb.load_ewma],
        }


def _snapshot_databank(arrays: dict, scalars: dict, bank: Any,
                       include_rows: bool) -> None:
    """``include_rows`` pulls every present device's splits into the
    snapshot — needed only under churn, where joined/drifted devices'
    data exists nowhere but the bank. Static populations skip the rows
    (the constructor rebuilds them exactly)."""
    if bank is None:
        scalars["databank"] = None
        return
    if include_rows:
        splits = bank.splits
        for d in bank.present_ids():
            r = bank.row_of[d]
            for k, (xs, ys) in splits.items():
                arrays[f"data/{d}/{k}/x"] = _host_array(xs[r])
                arrays[f"data/{d}/{k}/y"] = _host_array(ys[r]).astype(
                    np.int32)
    scalars["databank"] = {
        "n_shards": bank.n_shards,
        "rows_per_shard": bank.rows_per_shard,
        "next_id": bank.next_id,
        "present": bank.present_ids(),
        "row_of": {str(d): bank.row_of[d] for d in bank.present_ids()},
        "rows_saved": include_rows,
    }


def _snapshot_executor(arrays: dict, scalars: dict, ex: Any) -> None:
    if hasattr(ex, "_val_cache"):
        for m, row in ex._val_cache.items():
            arrays[f"evalcache/val/{m}"] = np.asarray(row)
        for m, row in ex._test_cache.items():
            arrays[f"evalcache/test/{m}"] = np.asarray(row)
        scalars["executor"] = {
            "pred_rows": list(ex._pred_rows),
            "needs_refresh": bool(ex._needs_refresh),
            "val_cached": sorted(ex._val_cache),
            "test_cached": sorted(ex._test_cache),
        }
    else:
        scalars["executor"] = None
    if getattr(ex, "_stale_updates", None):
        # the harvested rows live on the card: copied to the host here
        scalars["stale_keys"] = [[r, m, d]
                                 for r, m, d in sorted(ex._stale_updates)]
        for (r, m, d), tree in ex._stale_updates.items():
            arrays.update(_flatten(f"stale/{r}/{m}/{d}", tree))
    else:
        scalars["stale_keys"] = []


def _snapshot_prefetch(arrays: dict, scalars: dict,
                       prefetch: Optional[Tuple]) -> None:
    if prefetch is None:
        scalars["prefetch_round"] = None
        return
    scalars["prefetch_round"] = int(prefetch[0])
    participating, perms = prefetch[1]
    arrays["prefetch/participating"] = np.asarray(participating)
    arrays["prefetch/perms"] = np.asarray(perms)


def _snapshot_fedcd(server: Any) -> Tuple[dict, dict]:
    arrays: Dict[str, np.ndarray] = {}
    scalars: Dict[str, Any] = {}
    arrays["present"] = np.asarray(server.present)
    _snapshot_scores(arrays, server.state)
    _snapshot_params(arrays, scalars, server.registry)
    _snapshot_databank(arrays, scalars, _databank(server),
                       include_rows=(server.scenario is not None))
    _snapshot_executor(arrays, scalars, server.executor)
    _snapshot_prefetch(arrays, scalars, server._prefetch)
    scalars["registry"] = server.registry.to_json()
    scalars["rng"] = {"rng": _rng_state(server.rng),
                      "life_rng": _rng_state(server.life_rng),
                      "churn_rng": _rng_state(server._churn_rng)}
    coord = server.planner.semisync
    scalars["planner"] = {"sparse_rounds": server.planner.sparse_rounds}
    scalars["semisync"] = (coord.state_dict() if coord is not None
                           else None)
    if server.metrics:
        arrays["metrics/test_acc"] = np.stack(
            [m.test_acc for m in server.metrics])
        arrays["metrics/val_acc"] = np.stack(
            [m.val_acc for m in server.metrics])
        arrays["metrics/preferred"] = np.stack(
            [m.preferred for m in server.metrics])
    scalars["metrics"] = [
        {"round": m.round, "active_models": m.active_models,
         "live_models": m.live_models, "score_std": m.score_std,
         "comm_bytes": m.comm_bytes, "wall_s": m.wall_s}
        for m in server.metrics]
    scalars["n_devices"] = int(server.n_devices)
    scalars["batch_size"] = int(server.batch_size)
    return arrays, scalars


def _snapshot_fedavg(server: Any) -> Tuple[dict, dict]:
    arrays: Dict[str, np.ndarray] = {}
    scalars: Dict[str, Any] = {}
    arrays.update(_flatten("params/0", server.executor.get_params()))
    _snapshot_executor(arrays, scalars, server.executor)
    _snapshot_prefetch(arrays, scalars, server._prefetch)
    scalars["rng"] = {"rng": _rng_state(server.rng)}
    scalars["semisync"] = (server.semisync.state_dict()
                           if server.semisync is not None else None)
    if server.metrics:
        arrays["metrics/test_acc"] = np.stack(
            [m.test_acc for m in server.metrics])
        arrays["metrics/val_acc"] = np.stack(
            [m.val_acc for m in server.metrics])
    scalars["metrics"] = [
        {"round": m.round, "comm_bytes": m.comm_bytes, "wall_s": m.wall_s}
        for m in server.metrics]
    scalars["n_devices"] = int(server.n_devices)
    return arrays, scalars


def _snapshot_fedllm(server: Any) -> Tuple[dict, dict]:
    arrays: Dict[str, np.ndarray] = {}
    scalars: Dict[str, Any] = {}
    _snapshot_scores(arrays, server.state)
    _snapshot_params(arrays, scalars, server.registry)
    scalars["registry"] = server.registry.to_json()
    scalars["rng"] = {"rng": _rng_state(server.rng)}
    # the pipelined trainer's saved RNG stream is PAST round t+1's
    # draws — the prefetched inputs themselves must ride along or the
    # resumed round t+1 would re-draw from the wrong stream position
    pf = server._prefetch
    if pf is None:
        scalars["prefetch_round"] = None
    else:
        scalars["prefetch_round"] = int(pf[0])
        for name, a in zip(("participating", "tokens", "labels", "vt",
                            "vl"), pf[1:]):
            arrays[f"prefetch/{name}"] = np.asarray(a)
    if server.metrics:
        arrays["metrics/client_acc"] = np.stack(
            [m.client_acc for m in server.metrics])
    scalars["metrics"] = [
        {"round": m.round, "mean_loss": m.mean_loss,
         "live_models": m.live_models, "active_models": m.active_models,
         "score_std": m.score_std, "wall_s": m.wall_s,
         "trained_models": m.trained_models}
        for m in server.metrics]
    scalars["n_devices"] = int(server.n_clients)
    # cluster-shared draft rows (speculative serving, DESIGN.md §16):
    # population state like the target bank — keyed by model id
    draft = server.draft
    if draft is not None:
        scalars["draft"] = {
            "layers": int(draft.draft_layers),
            "present": sorted(int(m) for m in draft.present)}
        for m in sorted(draft.present):
            arrays.update(_flatten(f"draft/{m}", draft.row_params(
                draft.row(server.registry, m))))
    else:
        scalars["draft"] = None
    return arrays, scalars


# -- save --------------------------------------------------------------------

def save_server_state(server: Any, path: str,
                      crash_mid_save: bool = False) -> str:
    """Snapshot ``server``'s complete logical round state into directory
    ``path`` (between rounds only). Quiesces the executor first; commits
    ``arrays.npz`` and then — LAST — ``manifest.json``, both via tmp +
    ``os.replace``. ``crash_mid_save`` is the fault-injection hook: it
    raises :class:`~repro_torch.data.scenarios.SimulatedCrash` between
    the two commits, leaving a torn checkpoint no loader accepts."""
    ex = getattr(server, "executor", None)
    if ex is not None:
        if getattr(ex, "_pending", None) is not None:
            raise CheckpointError(
                "cannot snapshot mid-round: executor has a dispatched "
                "round pending readback")
        ex.quiesce()
    kind = _kind(server)
    arrays, scalars = {"fedcd": _snapshot_fedcd,
                       "fedavg": _snapshot_fedavg,
                       "fedllm": _snapshot_fedllm}[kind](server)
    last_round = server.metrics[-1].round if server.metrics else 0
    manifest = {
        "schema": SCHEMA,
        "kind": kind,
        "round": last_round,
        "engine": server.spec.canonical,
        "config": _config(server),
        "arrays": {k: {"crc32": _crc(v), "dtype": str(v.dtype),
                       "shape": list(v.shape)}
                   for k, v in arrays.items()},
        "state": scalars,
    }
    os.makedirs(path, exist_ok=True)
    atomic_savez(os.path.join(path, ARRAYS), arrays)
    if crash_mid_save:
        from repro_torch.data.scenarios import SimulatedCrash
        raise SimulatedCrash(
            f"scripted crash at round {last_round} (mid-save): arrays "
            "committed, manifest not — the checkpoint is torn")
    atomic_write_json(os.path.join(path, MANIFEST), manifest)
    return path


# -- load / validate ---------------------------------------------------------

def verify_checkpoint(path: str) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Load + fully validate a checkpoint directory: the manifest must
    exist and parse (manifest-last commit ordering makes its absence the
    torn-save signature), the npz key set must equal the manifest's, and
    every array must match its recorded crc32/dtype/shape. Raises
    :class:`CheckpointError` naming every offending key."""
    mpath = os.path.join(path, MANIFEST)
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError, OSError) as e:
        raise CheckpointError(
            f"no valid manifest at {path!r} (torn or missing "
            f"checkpoint): {e}") from e
    if manifest.get("schema") != SCHEMA:
        raise CheckpointError(
            f"checkpoint {path!r} schema {manifest.get('schema')} != "
            f"supported {SCHEMA}")
    try:
        data = np.load(os.path.join(path, ARRAYS))
        arrays = {k: data[k] for k in data.files}
    except (FileNotFoundError, ValueError, OSError) as e:
        raise CheckpointError(
            f"unreadable arrays at {path!r}: {e}") from e
    want = manifest["arrays"]
    if set(arrays) != set(want):
        raise CheckpointError(
            f"checkpoint {path!r} npz/manifest key mismatch: "
            f"npz-only={sorted(set(arrays) - set(want))} "
            f"manifest-only={sorted(set(want) - set(arrays))}")
    bad = [k for k in sorted(want)
           if _crc(arrays[k]) != want[k]["crc32"]
           or str(arrays[k].dtype) != want[k]["dtype"]
           or list(arrays[k].shape) != want[k]["shape"]]
    if bad:
        raise CheckpointError(
            f"checkpoint {path!r} corrupt arrays "
            f"(checksum/dtype/shape mismatch): {bad}")
    return manifest, arrays


def latest_checkpoint(root: str) -> Optional[str]:
    """Resolve ``root`` to its newest VALID checkpoint: ``root`` itself
    if it is a checkpoint directory, else the newest ``step_*`` child
    that passes :func:`verify_checkpoint` (torn/corrupt steps — e.g. a
    crash mid-save — are skipped, falling back to the previous save)."""
    if os.path.exists(os.path.join(root, MANIFEST)):
        return root
    if not os.path.isdir(root):
        return None
    for name in sorted(os.listdir(root), reverse=True):
        if not name.startswith("step_"):
            continue
        step = os.path.join(root, name)
        try:
            verify_checkpoint(step)
            return step
        except CheckpointError:
            continue
    return None


def _check_config(server: Any, manifest: dict) -> None:
    cfg = _config(server)
    saved = manifest["config"]
    diff = sorted(k for k in set(cfg) | set(saved)
                  if _jsonish(cfg.get(k)) != saved.get(k))
    if diff:
        raise CheckpointError(
            "checkpoint config mismatch on fields "
            f"{diff}: saved={ {k: saved.get(k) for k in diff} } "
            f"server={ {k: cfg.get(k) for k in diff} }")
    kind = _kind(server)
    if manifest["kind"] != kind:
        raise CheckpointError(
            f"checkpoint kind {manifest['kind']!r} cannot restore into "
            f"a {kind!r} server")
    n = server.n_clients if kind == "fedllm" else server.n_devices
    if manifest["state"]["n_devices"] != n:
        raise CheckpointError(
            f"device-id space mismatch: checkpoint "
            f"{manifest['state']['n_devices']} != server {n} "
            "(same scenario required)")


def _jsonish(v: Any) -> Any:
    """What ``v`` looks like after a JSON roundtrip (tuples → lists)."""
    return json.loads(json.dumps(v)) if v is not None else None


# -- restore -----------------------------------------------------------------

def _restore_scores(server: Any, arrays: dict) -> None:
    from repro_torch.core.scores import ScoreState

    hist = np.asarray(arrays["score/history"], np.float64)
    server.state = ScoreState(hist,
                              np.asarray(arrays["score/active"], bool),
                              np.asarray(arrays["score/alive"], bool),
                              ell=hist.shape[2])


def _restore_params(server: Any, manifest: dict, arrays: dict) -> None:
    scalars = manifest["state"]
    template = _param_template(server)
    reg = server.registry
    reg.load_json(scalars["registry"])
    live = reg.live_ids()
    rows = {m: _unflatten(template, arrays, f"params/{m}") for m in live}
    if scalars["stacked"]:
        if not isinstance(reg.params, StackedParamBank):
            raise CheckpointError(
                "stacked checkpoint cannot restore into a dict-mode "
                "registry (legacy/batched engine)")
        pb, saved = reg.params, scalars["bank"]
        if (pb.n_shards == saved["n_shards"]
                and pb.rows_per_shard == saved["rows_per_shard"]):
            pb.restore(rows,
                       row_of={int(m): r
                               for m, r in saved["row_of"].items()},
                       used_rows=set(saved["used_rows"]),
                       load_ewma=np.asarray(saved["load_ewma"]))
        else:
            # a checkpoint of another shard layout: ids re-place through
            # least-loaded placement on the NEW layout, from a cold EWMA
            pb.restore(rows)
    elif isinstance(reg.params, StackedParamBank):
        # dict-mode checkpoint (legacy engine) into a stacked registry:
        # the id-keyed rows land in the executor's own bank tensors
        reg.params.restore(rows)
    else:
        reg.params = {m: _to_server(rows[m], template, server.device)
                      for m in live}


def _restore_databank(server: Any, manifest: dict, arrays: dict) -> None:
    saved = manifest["state"]["databank"]
    bank = _databank(server)
    if saved is None or bank is None:
        # a dict-mode (legacy/batched) save carries no bank — those
        # engines forbid churn, so the constructor's initial data is
        # already exact
        return
    if not saved["rows_saved"]:
        # static population: the constructor rebuilt the rows exactly
        return
    devices = {}
    for d in saved["present"]:
        devices[d] = {k: (arrays[f"data/{d}/{k}/x"],
                          arrays[f"data/{d}/{k}/y"])
                      for k in ("train", "val", "test")}
    row_of = None
    if (bank.n_shards == saved["n_shards"]
            and bank.rows_per_shard == saved["rows_per_shard"]):
        row_of = {int(d): r for d, r in saved["row_of"].items()}
    bank.restore(devices, next_id=saved["next_id"], row_of=row_of)


def _restore_executor(server: Any, manifest: dict, arrays: dict) -> None:
    scalars = manifest["state"]
    ex = server.executor
    saved = scalars.get("executor")
    if saved is not None and hasattr(ex, "_val_cache"):
        ex._val_cache = {m: np.asarray(arrays[f"evalcache/val/{m}"])
                         for m in saved["val_cached"]}
        ex._test_cache = {m: np.asarray(arrays[f"evalcache/test/{m}"])
                          for m in saved["test_cached"]}
        ex._pred_rows = list(saved["pred_rows"])
        ex._needs_refresh = bool(saved["needs_refresh"])
    if scalars.get("stale_keys") and hasattr(ex, "_stale_updates"):
        # back on the server's device, where harvests keep them
        template = _param_template(server)
        ex._stale_updates = {
            (r, m, d): _to_server(
                _unflatten(template, arrays, f"stale/{r}/{m}/{d}"),
                template, server.device)
            for r, m, d in scalars["stale_keys"]}


def _restore_prefetch(server: Any, manifest: dict, arrays: dict) -> None:
    t = manifest["state"]["prefetch_round"]
    server._prefetch = None if t is None else (
        int(t), (np.asarray(arrays["prefetch/participating"]),
                 np.asarray(arrays["prefetch/perms"])))


def _restore_semisync(coord: Any, saved: Optional[dict]) -> None:
    if (saved is None) != (coord is None):
        raise CheckpointError(
            "semi-sync state mismatch: checkpoint "
            f"{'has' if saved else 'lacks'} a straggler buffer but the "
            f"server {'lacks' if saved else 'has'} a straggler model")
    if coord is not None:
        coord.load_state(saved)


def _restore_draft(server: Any, dmeta: Optional[dict],
                   arrays: Dict[str, np.ndarray]) -> None:
    """Adopt a checkpoint's draft rows into the trainer's draft bank, in
    place at the restored bank's rows; a checkpoint without them (saved
    by a trainer without drafts) re-derives them from the restored
    target rows (truncation is deterministic)."""
    draft = server.draft
    if draft is None:
        return
    if not dmeta:
        draft.present = set()
        draft.refresh(server.registry, params_of=server.executor.params_of)
        return
    if int(dmeta["layers"]) != int(draft.draft_layers):
        raise CheckpointError(
            f"draft depth mismatch: checkpoint has {dmeta['layers']} "
            f"layers, trainer wants {draft.draft_layers}")
    template = {k: torch.empty(v.shape[1:], dtype=v.dtype, device="meta")
                for k, v in draft.tree.items()}
    draft.present = set()
    for m in dmeta["present"]:
        row = _unflatten(template, arrays, f"draft/{m}")
        dst = draft.row_params(draft.row(server.registry, int(m)))
        for k, a in row.items():
            dst[k].copy_(to_device(a, a.dtype, dst[k].device))
        draft.present.add(int(m))


def restore_server_state(server: Any, path: str) -> int:
    """Restore a freshly-constructed ``server`` (same config and
    scenario) from the checkpoint at ``path``. Returns the last completed
    round; ``run(rounds)`` continues from the next one. Torn or corrupt
    checkpoints raise :class:`CheckpointError` — they are never silently
    loaded."""
    manifest, arrays = verify_checkpoint(path)
    _check_config(server, manifest)
    kind = _kind(server)
    scalars = manifest["state"]
    _set_rng(server.rng, scalars["rng"]["rng"])

    if kind == "fedcd":
        _set_rng(server.life_rng, scalars["rng"]["life_rng"])
        churn = scalars["rng"]["churn_rng"]
        if (churn is None) != (server._churn_rng is None):
            raise CheckpointError(
                "churn-scenario mismatch between checkpoint and server")
        if churn is not None:
            _set_rng(server._churn_rng, churn)
        server.present = np.asarray(arrays["present"], bool)
        _restore_scores(server, arrays)
        _restore_params(server, manifest, arrays)
        _restore_databank(server, manifest, arrays)
        _restore_executor(server, manifest, arrays)
        _restore_prefetch(server, manifest, arrays)
        server.planner.sparse_rounds = scalars["planner"]["sparse_rounds"]
        _restore_semisync(server.planner.semisync, scalars["semisync"])
        from repro_torch.core.fedcd import RoundMetrics
        server.metrics = [
            RoundMetrics(round=s["round"],
                         test_acc=arrays["metrics/test_acc"][i],
                         val_acc=arrays["metrics/val_acc"][i],
                         active_models=s["active_models"],
                         live_models=s["live_models"],
                         score_std=s["score_std"],
                         comm_bytes=s["comm_bytes"], wall_s=s["wall_s"],
                         preferred=arrays["metrics/preferred"][i])
            for i, s in enumerate(scalars["metrics"])]
    elif kind == "fedavg":
        template = _param_template(server)
        server.executor.set_params(_to_server(
            _unflatten(template, arrays, "params/0"), template,
            server.device))
        _restore_executor(server, manifest, arrays)
        _restore_prefetch(server, manifest, arrays)
        _restore_semisync(server.semisync, scalars["semisync"])
        from repro_torch.core.fedavg import FedAvgRound
        server.metrics = [
            FedAvgRound(round=s["round"],
                        test_acc=arrays["metrics/test_acc"][i],
                        val_acc=arrays["metrics/val_acc"][i],
                        comm_bytes=s["comm_bytes"], wall_s=s["wall_s"])
            for i, s in enumerate(scalars["metrics"])]
    else:                                # fedllm
        _restore_scores(server, arrays)
        _restore_params(server, manifest, arrays)
        pr = scalars.get("prefetch_round")
        if pr is not None and "prefetch/tokens" in arrays:
            server._prefetch = (
                int(pr),
                np.asarray(arrays["prefetch/participating"], bool),
                np.asarray(arrays["prefetch/tokens"]),
                np.asarray(arrays["prefetch/labels"]),
                np.asarray(arrays["prefetch/vt"]),
                np.asarray(arrays["prefetch/vl"]))
        else:
            server._prefetch = None
        _restore_draft(server, scalars.get("draft"), arrays)
        from repro_torch.federated.llm import LLMRoundMetrics
        server.metrics = [
            LLMRoundMetrics(round=s["round"], mean_loss=s["mean_loss"],
                            client_acc=arrays["metrics/client_acc"][i],
                            live_models=s["live_models"],
                            active_models=s["active_models"],
                            score_std=s["score_std"], wall_s=s["wall_s"],
                            trained_models=s.get("trained_models", 0))
            for i, s in enumerate(scalars["metrics"])]
    return manifest["round"]


# -- the periodic saver ------------------------------------------------------

class CheckpointManager:
    """Periodic snapshots under ``root/step_{t:06d}`` plus a ``LATEST``
    pointer (informational — :func:`latest_checkpoint` trusts only
    manifests). ``faults`` wires the mid-save crash injection."""

    def __init__(self, root: str, every: int = 0, faults: Any = None):
        self.root = root
        self.every = every
        self.faults = faults

    def step_dir(self, t: int) -> str:
        return os.path.join(self.root, f"step_{t:06d}")

    def maybe_save(self, server: Any, t: int) -> Optional[str]:
        if not self.every or t % self.every:
            return None
        return self.save(server, t)

    def save(self, server: Any, t: int) -> str:
        crash = (self.faults is not None
                 and self.faults.fires(t, "mid-save"))
        with telemetry.span("save"):
            path = save_server_state(server, self.step_dir(t),
                                     crash_mid_save=crash)
            atomic_write_bytes(os.path.join(self.root, LATEST),
                               os.path.basename(path).encode())
        return path
