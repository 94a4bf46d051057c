"""Meshes of device slots, ported from ``repro.launch.mesh``.

The reference lays a ("data", "model") mesh over jax devices.  The port
lays it over **slots**: a slot is a ``torch.device``, and several slots
may name the same card, so four slots on one H100 stand where the
reference's CI has four forced CPU devices.  A ``Mesh`` is read the way
the reference reads a jax ``Mesh``: ``mesh.shape["data"]``,
``mesh.axis_names``, ``mesh.devices`` (an object array of slots).

``visible_slots`` is the device list: every visible CUDA device, or the
CPU when there is none (the tests).  ``REPRO_TORCH_DEVICE_SLOTS=n`` makes
it n slots spread round-robin over those devices -- the port's
counterpart of ``XLA_FLAGS=--xla_force_host_platform_device_count=n``,
and read here only.  ``distributed.initialize_multiprocess`` sets it for
its process.

Model sharding (module 12b) lays a mesh over the ranks of a process group
instead: ``ShardMesh`` is a ``torch.distributed.DeviceMesh`` read the same
way (``.shape[...]``, ``.axis_names``), made by ``make_device_mesh`` (a
debug shape, or ``from_slots`` of a slot ``Mesh``'s shape) or
``make_production_mesh`` (the reference's (16, 16) pod and (2, 16, 16)
multi-pod meshes).  Its ranks are simulated in this process
(``distributed.simulated_world``); real ranks on several cards over NCCL
wait for more than one card.

Left out: the TPU's peak constants (the card's, its link rate among them,
are ``repro_torch.card.peaks``).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

SLOTS_ENV = "REPRO_TORCH_DEVICE_SLOTS"


class Mesh:
    """An n-dimensional array of slots with named axes."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.empty(np.shape(devices), dtype=object)
        arr[...] = devices
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-d slot array for axes "
                             f"{axis_names}")
        self.devices = arr
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, arr.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def slots(self, axes: Optional[Sequence[str]] = None) -> list:
        """The slots in row-major order of ``axes`` (default all axes),
        the order a flattened grid axis shards over them.  A slot array's
        other axes must be of size 1 or are left at their first index."""
        axes = self.axis_names if axes is None else tuple(axes)
        order = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in order]
        arr = np.transpose(self.devices, order + rest)
        arr = arr.reshape(arr.shape[:len(order)] + (-1,))[..., 0]
        return list(arr.reshape(-1))

    def __repr__(self) -> str:
        return (f"Mesh({', '.join(f'{a}={n}' for a, n in self.shape.items())};"
                f" {sorted({str(d) for d in self.devices.flat})})")


def visible_slots(device_type: Optional[str] = None) -> list:
    """The visible CUDA devices (the CPU when there is none, or when
    ``device_type`` is "cpu"), or ``REPRO_TORCH_DEVICE_SLOTS`` slots
    spread round-robin over them."""
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if device_type == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [torch.device("cpu")]
    n = os.environ.get(SLOTS_ENV)
    if not n:
        return devices
    n = int(n)
    if n < 1:
        raise ValueError(f"{SLOTS_ENV}={n}: need at least one slot")
    return [devices[i % len(devices)] for i in range(n)]


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              slots: Optional[Sequence[torch.device]] = None) -> Mesh:
    """The first prod(shape) of ``slots`` (default ``visible_slots()``) as
    a mesh; raises when fewer are there, as ``jax.make_mesh`` does."""
    slots = visible_slots() if slots is None else list(slots)
    need = int(np.prod(shape))
    if len(slots) < need:
        raise ValueError(
            f"a mesh of shape {tuple(shape)} needs {need} slots, "
            f"{len(slots)} visible; set {SLOTS_ENV}={need} for {need} slots "
            "on the visible devices")
    arr = np.empty(need, dtype=object)
    arr[:] = slots[:need]
    return Mesh(arr.reshape(tuple(shape)), axis_names)


def make_debug_mesh(data: int = 2, model: int = 2, *,
                    multi_pod: bool = False, slots=None) -> Mesh:
    """Tiny ("data", "model") mesh (("pod", "data", "model") with
    ``multi_pod``) over the visible slots, or ``slots``."""
    if multi_pod:
        return make_mesh((2, data, model), ("pod", "data", "model"), slots)
    return make_mesh((data, model), ("data", "model"), slots)


def num_clients(mesh) -> int:
    """FL clients = pod x data slices."""
    n = mesh.shape["data"]
    if "pod" in mesh.axis_names:
        n *= mesh.shape["pod"]
    return int(n)


def batch_axes(mesh) -> tuple:
    return (("pod", "data") if "pod" in mesh.axis_names else ("data",))


def grid_axes(mesh) -> tuple:
    """Mesh axes a flattened sweep grid shards over: fleet cells are
    independent programs, so the whole mesh -- every axis, pods included
    -- is one flat pool of cell slots."""
    return tuple(mesh.axis_names)


class ShardMesh:
    """A ``torch.distributed.DeviceMesh`` of ranks with named axes, read as
    the reference reads a jax ``Mesh``: ``shape`` (axis name -> size),
    ``axis_names``, ``size``; ``device_mesh`` is the DeviceMesh that
    DTensors are laid out on."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.shape))
        self.device_type = device_mesh.device_type

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def local_rank(self, axis: str):
        """This rank's coordinate on ``axis``: an int, or under
        ``LocalTensorMode`` one int per simulated rank (a SymInt)."""
        return self.device_mesh.get_local_rank(axis)

    def __repr__(self) -> str:
        return (f"ShardMesh({', '.join(f'{a}={n}' for a, n in self.shape.items())};"
                f" {self.device_type})")


def make_device_mesh(shape: Sequence[int], axis_names: Sequence[str],
                     device_type: str = "cpu") -> ShardMesh:
    """A mesh of prod(shape) ranks of the open process group (a
    ``distributed.simulated_world`` of that many) on ``device_type``."""
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh
    need = int(np.prod(shape))
    if not tdist.is_initialized() or tdist.get_world_size() != need:
        raise RuntimeError(
            f"a mesh of shape {tuple(shape)} needs a world of {need} ranks: "
            f"open distributed.simulated_world({need}) first")
    return ShardMesh(init_device_mesh(device_type, tuple(shape),
                                      mesh_dim_names=tuple(axis_names)))


def from_slots(mesh: Mesh, device_type: Optional[str] = None) -> ShardMesh:
    """The ranks' mesh of a slot ``Mesh``'s shape and axes, on
    ``device_type`` (default: the type of its first slot)."""
    if device_type is None:
        device_type = mesh.devices.flat[0].type
    return make_device_mesh(tuple(mesh.shape.values()), mesh.axis_names,
                            device_type)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu") -> ShardMesh:
    """The reference's production mesh: ("data", "model") = (16, 16), or
    with ``multi_pod`` ("pod", "data", "model") = (2, 16, 16); over a
    ``distributed.simulated_world`` of 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_device_mesh(shape, axes, device_type)


def make_debug_device_mesh(data: int = 2, model: int = 2, *,
                           multi_pod: bool = False,
                           device_type: str = "cpu") -> ShardMesh:
    """``make_debug_mesh``'s shapes over ranks: (data, model), or
    (2, data, model) with ``multi_pod``."""
    if multi_pod:
        return make_device_mesh((2, data, model), ("pod", "data", "model"),
                                device_type)
    return make_device_mesh((data, model), ("data", "model"), device_type)
