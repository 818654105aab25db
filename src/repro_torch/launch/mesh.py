"""The federated engines' launch mesh (port of ``repro/launch/mesh.py:
31-71``, the launch-mesh half).

The reference lays its stacked banks over a ``jax.sharding.Mesh`` and
runs one ``shard_map`` program per round: one host process plans every
shard. The port keeps that single controller. A :class:`LaunchMesh` is a
``(model, data)`` grid of ``torch.device`` cells; the sharded executors
run each cell's block of the round on that cell's device, and move the
few cross-cell tensors themselves (the data-axis sum that completes eq 1,
FedAvg's sum over both axes, the readback of the row-sharded eval
matrices), in a fixed order.

Cells may share a device: ``make_launch_mesh(4, 1, devices=[dev] * 4)``
puts four model shards on one device, the port's analogue of the
reference's ``--xla_force_host_platform_device_count``. Where cells share
a device one tensor serves them all. Without ``devices`` the mesh takes
the first ``model * data`` CUDA devices and raises when there are fewer,
as ``jax.make_mesh`` does beyond ``jax.device_count()``: it never
shrinks and never moves to the CPU.

``dp_axes_of`` / ``dp_size`` name the data-parallel axes of a mesh, as
the LM sharding rules (``launch/sharding.py``) read them. The production
meshes (``make_production_mesh``) belong to the dry-run tooling (ROADMAP
item 15b.2) and are not ported here.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

AXES = ("model", "data")

DeviceLike = Union[str, torch.device]


class LaunchMesh:
    """A ``(model, data)`` grid of devices, cells model-major: cell
    ``(sm, sd)`` is ``devices[sm * data + sd]``. Model shard ``sm``'s
    bank block is resident on every cell ``(sm, ·)``, data shard ``sd``'s
    block on every cell ``(·, sd)``; the owner of a block is its cell
    with the other index 0."""

    axis_names = AXES

    def __init__(self, model: int, data: int,
                 devices: Sequence[DeviceLike]):
        if model < 1 or data < 1:
            raise ValueError(f"mesh axes must be >= 1: {model}x{data}")
        devs = [torch.device(d) for d in devices]
        if len(devs) != model * data:
            raise ValueError(f"a {model}x{data} mesh needs {model * data} "
                             f"devices, got {len(devs)}")
        for d in devs:
            if d.type not in ("cuda", "cpu"):
                raise ValueError(f"unsupported mesh device {d}")
        self._model, self._data = model, data
        self.devices: List[torch.device] = devs

    @property
    def shape(self) -> Dict[str, int]:
        return {"model": self._model, "data": self._data}

    @property
    def size(self) -> int:
        return self._model * self._data

    def device(self, sm: int, sd: int = 0) -> torch.device:
        """The device of cell ``(sm, sd)``."""
        return self.devices[sm * self._data + sd]

    def __repr__(self) -> str:
        return (f"LaunchMesh(model={self._model}, data={self._data}, "
                f"devices={[str(d) for d in self.devices]})")


def _cuda_devices(n: int) -> List[torch.device]:
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise ValueError(
            f"a launch mesh of {n} cells needs {n} CUDA devices, found "
            f"{have}; pass devices=[...] to place several cells on one "
            "device (e.g. devices=['cuda:0'] * n, or ['cpu'] * n)")
    return [torch.device("cuda", i) for i in range(n)]


def make_launch_mesh(model: int = 1, data: int = 1,
                     devices: Optional[Sequence[DeviceLike]] = None
                     ) -> LaunchMesh:
    """The federated engines' 2-D ``(model × data)`` launch mesh: the
    stacked parameter bank's row axis lays out over ``model``, the device
    data bank's row axis over ``data``, the gathered work pairs over both
    (one block per cell, model-major). ``devices``: one per cell,
    model-major; ``None`` takes the first ``model * data`` CUDA devices
    and raises if there are fewer."""
    if devices is None:
        devices = _cuda_devices(model * data)
    return LaunchMesh(model, data, devices)


def make_model_mesh(n_shards: int,
                    devices: Optional[Sequence[DeviceLike]] = None
                    ) -> LaunchMesh:
    """1-D model sharding: ``make_launch_mesh`` with a singleton data
    axis (the 1-data-shard oracle of the 2-D data plane)."""
    return make_launch_mesh(model=n_shards, data=1, devices=devices)


def make_host_mesh(data: int = 1, model: int = 1) -> LaunchMesh:
    """A small mesh of CPU cells, for tests (every cell on the host)."""
    return make_launch_mesh(model=model, data=data,
                            devices=["cpu"] * (model * data))


def model_axis_size(mesh: LaunchMesh) -> int:
    return mesh.shape.get("model", 1)


def data_axis_size(mesh: LaunchMesh) -> int:
    return mesh.shape.get("data", 1)


def dp_axes_of(mesh: LaunchMesh) -> Tuple[str, ...]:
    """The mesh's data-parallel axes (``pod`` and ``data`` where present:
    ``("data",)`` on a launch mesh)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def dp_size(mesh: LaunchMesh) -> int:
    """Cells along the data-parallel axes."""
    n = 1
    for a in dp_axes_of(mesh):
        n *= mesh.shape[a]
    return n
