"""Carry parameters between the reference's pytrees and the port's flat
param dicts.

A reference pytree (nested dicts and lists of arrays, as numpy) maps to
a flat ``{name: tensor}`` dict in the reference's leaf order: dict keys
sorted, list items in order, names joined with ``.`` (``conv.3`` is
``tree["conv"][3]``). Layouts are unchanged — the port keeps the
reference's HWIO conv kernels and ``(in, out)`` dense weights.
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
            flat[prefix[:-1]] = torch.from_numpy(arr).to(device)

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
        node[parts[-1]] = t.detach().cpu().numpy()

    def listify(node: Any) -> Any:
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[k] for k in sorted(out, key=int)]
        return out

    return listify(root)
