"""Device-resident data bank (port of ``repro/data/bank.py``, static
population).

Holds every device's train/val/test splits as one stacked ``(N, n, ...)``
tensor pair per split on the server's device. With a static population
the device id is the data row (the reference's ``row_of`` is the
identity); joins, leaves, drifts and data sharding come with the churn
slice. ``version`` counts data-row writes, as the reference's does; with
a static population nothing writes rows, so it stays 0.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

SPLITS = ("train", "val", "test")


class DeviceDataBank:
    def __init__(self, data: Dict[str, Tuple[np.ndarray, np.ndarray]],
                 device: torch.device):
        """``data``: stacked device splits from ``partition.
        stack_devices``. Images stay float32 NHWC; labels become int64
        (the index type PyTorch's gathers take)."""
        self.n_devices = int(np.asarray(data["train"][0]).shape[0])
        self.version = 0
        self.splits: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        for k in SPLITS:
            xs, ys = data[k]
            if np.asarray(xs).shape[0] != self.n_devices:
                raise ValueError(f"{k} split has {np.asarray(xs).shape[0]} "
                                 f"devices, train has {self.n_devices}")
            self.splits[k] = (
                torch.as_tensor(np.asarray(xs, np.float32), device=device),
                torch.as_tensor(np.asarray(ys, np.int64), device=device))

    def __contains__(self, device_id: int) -> bool:
        return 0 <= device_id < self.n_devices
