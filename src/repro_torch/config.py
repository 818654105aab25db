"""FedCD algorithm hyperparameters (port of ``repro/config.py``,
``FedCDConfig`` and the serialisation helpers — the LM architecture
configs come with the mode-B slice)."""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, Tuple


@dataclass(frozen=True)
class FedCDConfig:
    """Hyperparameters of the FedCD algorithm (paper section 2 & 3.1)."""

    n_devices: int = 30
    devices_per_round: int = 15      # K
    local_epochs: int = 1            # E
    score_window: int = 3            # ℓ (eq 2)
    milestones: Tuple[int, ...] = (5, 15, 25, 30)
    late_delete_round: int = 20      # after this, 2-model devices may drop one
    late_delete_threshold: float = 0.3
    score_noise: float = 0.01        # "with some randomization" (sec 2)
    max_models: int = 16             # safety cap (2^#milestones)
    quantize_bits: int = 0           # 0 = off; 8 = int8 transport compression
    lr: float = 0.05
    momentum: float = 0.0
    seed: int = 0


def to_dict(cfg: Any) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def to_json(cfg: Any) -> str:
    return json.dumps(to_dict(cfg), indent=2)


def override(cfg: Any, **kw: Any) -> Any:
    """Replace fields, supporting dotted paths for nested dataclasses.

    >>> override(cfg, **{"lr": 0.01, "milestones": (2, 5)})
    """
    nested: Dict[str, Dict[str, Any]] = {}
    flat: Dict[str, Any] = {}
    for k, v in kw.items():
        if "." in k:
            head, rest = k.split(".", 1)
            nested.setdefault(head, {})[rest] = v
        else:
            flat[k] = v
    for head, sub in nested.items():
        flat[head] = override(getattr(cfg, head), **sub)
    return dataclasses.replace(cfg, **flat)
