"""Carry parameters and decode caches between the reference's pytrees
and the port's flat dicts.

A reference pytree (nested dicts and lists of arrays, as numpy) maps to
a flat ``{name: tensor}`` dict in the reference's leaf order: dict keys
sorted, list items in order, names joined with ``.`` (``conv.3`` is
``tree["conv"][3]``). Layouts are unchanged — the port keeps the
reference's HWIO conv kernels and ``(in, out)`` dense weights.

bfloat16 leaves cross in both directions: the reference's (ml_dtypes)
bfloat16 arrays widen to float32 and cast to ``torch.bfloat16``, and a
bfloat16 tensor leaves as a float32 array. Both widenings are exact.
Integer leaves keep their dtype (a cache's ``index`` and ``pos`` stay
int32).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.models.common import Params


def params_from_jax(tree: Any, device: Optional[Union[str, torch.device]]
                    = None) -> Params:
    """Nested dicts/lists of arrays -> flat param dict on ``device``
    (default CPU). Arrays are copied."""
    flat: Params = {}

    def walk(prefix: str, node: Any) -> None:
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{prefix}{k}.", node[k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}{i}.", v)
        else:
            arr = np.array(node)
            if arr.dtype.kind == "V" or str(arr.dtype) == "bfloat16":
                t = torch.from_numpy(arr.astype(np.float32)).to(
                    torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            flat[prefix[:-1]] = t.to(device)

    walk("", tree)
    return flat


def params_to_numpy(params: Params) -> Any:
    """Flat param dict -> nested dicts/lists of numpy arrays with the
    reference's structure (the inverse of :func:`params_from_jax`)."""
    root: Dict[str, Any] = {}
    for name, t in params.items():
        node = root
        parts = name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        node[parts[-1]] = t.cpu().numpy()

    def listify(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[k] for k in sorted(out, key=int)]
        return out

    return listify(root)


def caches_from_jax(tree: Any, device: Optional[Union[str, torch.device]]
                    = None) -> Params:
    """A reference decode-cache tree (``init_lm_caches``' list of
    segment caches or the hybrid's dict, ``init_encdec_caches``' dict, a
    verify's collected states) -> the port's flat cache dict; the same
    walk as :func:`params_from_jax`."""
    return params_from_jax(tree, device)


def caches_to_numpy(caches: Params) -> Any:
    """The port's flat cache dict -> the reference's cache tree of numpy
    arrays (a list of segment caches for a decoder-only stack)."""
    return params_to_numpy(caches)
