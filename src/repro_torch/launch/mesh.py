"""The launch meshes (port of ``repro/launch/mesh.py``, whole).

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

A mesh may also have a ``pod`` axis (the multi-pod production mesh,
``2 x 16 x 16`` over ``pod, data, model``). The port folds it into the
data-parallel coordinate: a mesh of ``pod=P, data=D, model=M`` keeps the
model-major grid over a flat data-parallel index ``sd = pod * D + data``
of :func:`dp_size` cells, so a spec entry ``("pod", "data")`` (JAX's
first-named-is-major order) reads as one data axis of ``P * D`` cells.
``axis_names`` names ``pod`` only where ``pod > 1``: every launch mesh
of the engines keeps its cells, their order and its axis names.

The production meshes (:func:`make_production_mesh`) hold 256 and 512
cells; no machine has that many cards, so their cells are ``meta``
devices by default: tensors there have shapes and dtypes and no storage,
which is what the dry run (``launch/dryrun.py``) traces. ``meta`` cells
are admitted beside ``cuda`` and ``cpu`` ones.

``dp_axes_of`` / ``dp_size`` name the data-parallel axes of a mesh, as
the LM sharding rules (``launch/sharding.py``) read them.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

DeviceLike = Union[str, torch.device]
DEVICE_TYPES = ("cuda", "cpu", "meta")


class LaunchMesh:
    """A ``(model, data)`` grid of devices, cells model-major: cell
    ``(sm, sd)`` is ``devices[sm * dp + sd]``, ``dp = pod * data`` (the
    flat data-parallel index of a ``pod`` mesh, module docstring). Model
    shard ``sm``'s bank block is resident on every cell ``(sm, ·)``, data
    shard ``sd``'s block on every cell ``(·, sd)``; the owner of a block
    is its cell with the other index 0."""

    def __init__(self, model: int, data: int,
                 devices: Sequence[DeviceLike], pod: int = 1):
        if model < 1 or data < 1 or pod < 1:
            raise ValueError(f"mesh axes must be >= 1: pod {pod}, "
                             f"{model}x{data}")
        n = model * data * pod
        devs = [torch.device(d) for d in devices]
        if len(devs) != n:
            raise ValueError(f"a {pod}x{model}x{data} mesh needs {n} "
                             f"devices, got {len(devs)}")
        for d in devs:
            if d.type not in DEVICE_TYPES:
                raise ValueError(f"unsupported mesh device {d}")
        self._model, self._data, self._pod = model, data, pod
        self.axis_names: Tuple[str, ...] = (
            ("model", "pod", "data") if pod > 1 else ("model", "data"))
        self.devices: List[torch.device] = devs

    @property
    def shape(self) -> Dict[str, int]:
        out = {"model": self._model, "data": self._data}
        if self._pod > 1:
            out["pod"] = self._pod
        return out

    @property
    def size(self) -> int:
        return self._model * self._data * self._pod

    def device(self, sm: int, sd: int = 0) -> torch.device:
        """The device of cell ``(sm, sd)`` (``sd`` the flat data-parallel
        index)."""
        return self.devices[sm * self._data * self._pod + sd]

    def __repr__(self) -> str:
        pod = f"pod={self._pod}, " if self._pod > 1 else ""
        return (f"LaunchMesh({pod}model={self._model}, data={self._data}, "
                f"devices={[str(d) for d in self.devices]})")


def _cuda_devices(n: int) -> List[torch.device]:
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise ValueError(
            f"a launch mesh of {n} cells needs {n} CUDA devices, found "
            f"{have}; pass devices=[...] to place several cells on one "
            "device (e.g. devices=['cuda:0'] * n, or ['cpu'] * n)")
    return [torch.device("cuda", i) for i in range(n)]


def _make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
               devices: Optional[Sequence[DeviceLike]] = None
               ) -> LaunchMesh:
    """A mesh of the named axis sizes (``axes`` among ``pod``, ``data``,
    ``model``; a missing axis has size 1), as the reference's
    ``jax.make_mesh(shape, axes)``. ``devices``: one per cell,
    model-major; ``None`` takes CUDA devices as
    :func:`make_launch_mesh`."""
    sizes = dict(zip(axes, shape))
    unknown = set(sizes) - {"pod", "data", "model"}
    if unknown:
        raise ValueError(f"a launch mesh has no axes {sorted(unknown)}")
    model, data, pod = (sizes.get(a, 1) for a in ("model", "data", "pod"))
    if devices is None:
        devices = _cuda_devices(model * data * pod)
    return LaunchMesh(model, data, devices, pod=pod)


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence[DeviceLike]] = None
                         ) -> LaunchMesh:
    """The production meshes: ``16 x 16`` over ``(data, model)``, or
    ``2 x 16 x 16`` over ``(pod, data, model)``. Cells are ``meta``
    devices unless ``devices`` names them (module docstring)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if devices is None:
        devices = [torch.device("meta")] * math.prod(shape)
    return _make_mesh(shape, axes, devices)


def make_launch_mesh(model: int = 1, data: int = 1,
                     devices: Optional[Sequence[DeviceLike]] = None,
                     pod: int = 1) -> LaunchMesh:
    """The federated engines' 2-D ``(model × data)`` launch mesh: the
    stacked parameter bank's row axis lays out over ``model``, the device
    data bank's row axis over ``data``, the gathered work pairs over both
    (one block per cell, model-major). ``devices``: one per cell,
    model-major; ``None`` takes the first ``model * data * pod`` CUDA
    devices and raises if there are fewer. ``pod``: the LM mesh's pod
    axis (module docstring); the engines run ``pod=1``."""
    return _make_mesh((pod, data, model), ("pod", "data", "model"),
                      devices)


def make_model_mesh(n_shards: int,
                    devices: Optional[Sequence[DeviceLike]] = None
                    ) -> LaunchMesh:
    """1-D model sharding: ``make_launch_mesh`` with a singleton data
    axis (the 1-data-shard oracle of the 2-D data plane)."""
    return make_launch_mesh(model=n_shards, data=1, devices=devices)


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 1
                   ) -> LaunchMesh:
    """A small mesh of CPU cells, for tests (every cell on the host)."""
    return make_launch_mesh(model=model, data=data, pod=pod,
                            devices=["cpu"] * (model * data * pod))


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
