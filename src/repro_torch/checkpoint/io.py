"""Checkpoint IO (port of ``repro/checkpoint/io.py``): a tree of arrays
-> flat npz (+ JSON meta), registry -> JSON.

A tree is the port's flat param dict (``{"conv.3": tensor}``) or nested
dicts and lists of tensors or numpy arrays. Its npz keys are the
reference's pytree paths, ``/``-joined, so either package reads what the
other wrote: dict keys sorted, list items by index, and a ``.`` inside a
key is a path separator (port param ``conv.3`` is the reference's
``tree["conv"][3]``, key ``conv/3``). bfloat16 leaves widen to float32 in
the file (npz has no bfloat16; the widening is exact) and cast back on
load.

Crash consistency: every file is written to a ``.tmp`` sibling and
committed with ``os.replace``, and the meta/manifest file — the only
thing a loader trusts — is written LAST. A crash at any point therefore
leaves either the previous complete checkpoint or a torn one the loader
rejects; it never half-accepts. ``load_checkpoint`` is strict: the npz
key set must equal the template's AND the meta's, and every array must
match its recorded crc32 — mismatches raise :class:`CheckpointError`
naming the offending keys.
"""
from __future__ import annotations

import io
import json
import os
import zlib
from typing import Any, Dict, List, Tuple

import numpy as np
import torch


class CheckpointError(ValueError):
    """A checkpoint is torn, corrupt, or does not match its consumer
    (missing/extra/mismatched keys, checksum failures, wrong config)."""


def _leaves_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in the reference's pytree order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _leaves_with_paths(
            tree[k], f"{prefix}{str(k).replace('.', '/')}/")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _leaves_with_paths(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _host_array(leaf: Any) -> np.ndarray:
    """A leaf as a host numpy array (waits for the device where it lives
    there); bfloat16 widened to float32."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy()
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V" or str(arr.dtype) == "bfloat16":
        arr = arr.astype(np.float32)
    return arr


def _flatten_with_paths(tree: Any) -> Dict[str, np.ndarray]:
    return {k: _host_array(v) for k, v in _leaves_with_paths(tree)}


def _like(arr: np.ndarray, leaf: Any) -> Any:
    """``arr`` as the template ``leaf``'s kind and dtype: a host tensor
    for a tensor leaf, a numpy array otherwise."""
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(leaf.dtype)
    return np.asarray(arr, np.asarray(leaf).dtype)


def _rebuild(tree: Any, values: Dict[str, Any], prefix: str = "") -> Any:
    """``tree``'s structure with each leaf replaced by its key's value."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, values,
                            f"{prefix}{str(k).replace('.', '/')}/")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, values, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return values[prefix[:-1]]


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def atomic_write_bytes(path: str, payload: bytes) -> None:
    """Write-to-tmp + fsync + ``os.replace``: after this returns (or
    crashes) ``path`` holds either its previous content or ``payload``,
    never a prefix."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def atomic_write_json(path: str, obj: Any) -> None:
    atomic_write_bytes(path, json.dumps(obj, indent=2).encode())


def atomic_savez(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """npz written via the same tmp + replace commit."""
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    atomic_write_bytes(path, buf.getvalue())


def save_checkpoint(path: str, tree: Any, step: int = 0,
                    extra: Dict[str, Any] | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten_with_paths(tree)
    base = path.removesuffix(".npz")
    atomic_savez(base + ".npz", flat)
    # meta commits LAST: a crash between the two leaves the npz without
    # its meta, which load_checkpoint treats as no checkpoint at all
    meta = {"step": step, "keys": sorted(flat),
            "checksums": {k: _crc(v) for k, v in flat.items()},
            "extra": extra or {}}
    atomic_write_json(base + ".meta.json", meta)


def load_checkpoint(path: str, like: Any, strict: bool = True
                    ) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (template tree): tensor
    leaves come back as host tensors of the template's dtype, numpy
    leaves as numpy arrays.

    ``strict`` (default) validates the npz key set against BOTH the
    template and ``meta["keys"]``, and verifies every array's crc32
    against the meta's record; any mismatch raises
    :class:`CheckpointError` naming the keys."""
    base = path.removesuffix(".npz")
    try:
        data = np.load(base + ".npz")
        with open(base + ".meta.json") as f:
            meta = json.load(f)
    except (FileNotFoundError, zlib.error, ValueError, OSError) as e:
        raise CheckpointError(f"unreadable checkpoint {base!r}: {e}") from e
    flat_like = dict(_leaves_with_paths(like))
    leaves_by_key = {k: data[k] for k in data.files}
    missing = set(flat_like) - set(leaves_by_key)
    if missing:
        raise CheckpointError(
            f"checkpoint {base!r} missing keys: {sorted(missing)}")
    if strict:
        extra_keys = set(leaves_by_key) - set(flat_like)
        if extra_keys:
            raise CheckpointError(
                f"checkpoint {base!r} has extra keys not in the "
                f"template: {sorted(extra_keys)}")
        recorded = set(meta.get("keys", []))
        if recorded != set(leaves_by_key):
            raise CheckpointError(
                f"checkpoint {base!r} npz/meta key mismatch: "
                f"npz-only={sorted(set(leaves_by_key) - recorded)} "
                f"meta-only={sorted(recorded - set(leaves_by_key))}")
        bad = [k for k, want in meta.get("checksums", {}).items()
               if _crc(leaves_by_key[k]) != want]
        if bad:
            raise CheckpointError(
                f"checkpoint {base!r} checksum mismatch "
                f"(corrupt arrays): {sorted(bad)}")
    values = {k: _like(leaves_by_key[k], leaf)
              for k, leaf in flat_like.items()}
    return _rebuild(like, values), meta["step"]


def save_registry(path: str, registry_state: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    atomic_write_json(path, registry_state)


def load_registry(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)
