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

Left out: ``make_production_mesh`` (a 16 x 16 TPU mesh, which waits for
model sharding across cards) and the TPU's peak constants (the card's are
``repro_torch.card.peaks``).
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
