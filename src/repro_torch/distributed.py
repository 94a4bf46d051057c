"""The grid's placement primitives and the multi-process bring-up, ported
from the grid half of ``repro.distributed``.

``shard_vmap`` maps a function over a flattened grid of independent cells
(fleet cells, SCA design rows) sharded over the slots of a mesh
(``launch.mesh``): cells are independent, so nothing is exchanged between
slots, only inputs scattered and outputs gathered.

Multi-process bring-up: ``initialize_multiprocess`` joins P processes to
one ``torch.distributed.TCPStore``, hosted by process 0 at the
coordinator's address.  As in the reference, execution is PROCESS-SLICED:
each process runs its contiguous ``process_grid_slice`` of the flattened
cell axis on a mesh of its LOCAL slots, and the processes check that they
agree by exchanging result digests through ``kv_put`` / ``kv_get``
(``repro_torch.grid_smoke``).  Cells are independent and only strings are
exchanged, so no process group is created.

Left out, for model sharding across cards: ``bind``, ``constrain``,
``logical_to_spec``, ``mesh_rules``, ``active_mesh``, ``batch_logical`` and
``shard_map``.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Callable, Optional

import torch

from repro_torch.launch import mesh as mesh_mod

_STATE: dict = {}


def tree_map(fn: Callable, tree):
    """``fn`` on every tensor leaf of dicts, lists, tuples (named ones
    too) and dataclasses (``solvers.theory.SolverParams``); other leaves
    (None, numbers, strings) as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def tree_cat(trees):
    """Concatenate same-structured trees leaf by leaf along axis 0."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(list(trees))
    if dataclasses.is_dataclass(first) and not isinstance(first, type):
        return dataclasses.replace(first, **{
            f.name: tree_cat([getattr(t, f.name) for t in trees])
            for f in dataclasses.fields(first) if f.init})
    if isinstance(first, dict):
        return {k: tree_cat([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(tree_cat([t[i] for t in trees])
                             for i in range(len(first))))
    if isinstance(first, (list, tuple)):
        return type(first)(tree_cat([t[i] for t in trees])
                           for i in range(len(first)))
    return first


def grid_devices(mesh, axes=("data", "model")) -> int:
    """Number of slots a flattened grid axis shards over: the product of
    the named mesh axis sizes."""
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return int(n)


def grid_slots(mesh, axes=("data", "model")) -> list:
    """The slots a flattened grid axis shards over, in block order."""
    return mesh.slots(tuple(axes))


def pad_rows(tree, g: int, gp: int):
    """Right-pad every leaf's leading [g] axis to ``gp`` with copies of
    row 0."""
    if gp == g:
        return tree
    return tree_map(lambda a: torch.cat(
        [a, a[:1].expand((gp - g,) + tuple(a.shape[1:]))]), tree)


def shard_vmap(fn: Callable, mesh, axes=("data", "model"),
               num_sharded: int = 1) -> Callable:
    """Map ``fn`` over a leading grid axis, sharded jointly over the slots
    of ``mesh``'s ``axes``.

    ``fn(*sharded, *bcast)`` is already batched over the leading [G] axis
    of its first ``num_sharded`` arguments (every tensor leaf carries it);
    the other arguments are broadcast.  The returned callable takes the
    same arguments.  The rules are the reference's: when G does not
    divide the slot count P, the grid is right-padded with copies of row 0
    up to the next multiple of P (valid inputs: the padded rows compute
    real, discarded work and can never poison anything with NaNs); it is
    cut into P contiguous blocks, one per slot in slot order; each block's
    sharded operands and the broadcast operands move to its slot's device
    (a no-op where the slot is the tensor's device already); ``fn`` runs
    on each block; the outputs are gathered on the first slot's device
    and the padded rows sliced off."""
    slots = grid_slots(mesh, axes)
    n = len(slots)

    def call(*args):
        sharded, bcast = args[:num_sharded], args[num_sharded:]
        g = int(tree_leaves(sharded[0])[0].shape[0])
        per = -(-g // n)
        sharded = pad_rows(sharded, g, per * n)
        outs = []
        for i, dev in enumerate(slots):
            block = tree_map(lambda a, i=i, dev=dev:
                             a[i * per:(i + 1) * per].to(dev), sharded)
            outs.append(fn(*block, *tree_map(lambda a, dev=dev: a.to(dev),
                                             bcast)))
        home = slots[0]
        out = tree_cat([tree_map(lambda a: a.to(home), o) for o in outs])
        return tree_map(lambda a: a[:g], out)

    return call


def initialize_multiprocess(coordinator_address: str, num_processes: int,
                            process_id: int,
                            local_device_count: Optional[int] = None,
                            timeout_s: float = 300.0):
    """Join this process to a P-process cluster: process 0 hosts a
    ``TCPStore`` at ``coordinator_address`` ("host:port"), the others
    connect to it.  ``local_device_count`` sets this process's slot count
    (``REPRO_TORCH_DEVICE_SLOTS``, read by ``launch.mesh.visible_slots``),
    as the reference forces its host-platform device count in the same
    call.  Returns (process count, local slot count)."""
    if not 0 <= int(process_id) < int(num_processes):
        raise ValueError(f"process {process_id} outside [0, {num_processes})")
    if local_device_count:
        os.environ[mesh_mod.SLOTS_ENV] = str(int(local_device_count))
    host, port = coordinator_address.rsplit(":", 1)
    store = torch.distributed.TCPStore(
        host, int(port), int(num_processes), int(process_id) == 0,
        timeout=datetime.timedelta(seconds=timeout_s))
    _STATE.update(store=store, process_id=int(process_id),
                  num_processes=int(num_processes))
    return int(num_processes), len(mesh_mod.visible_slots())


def process_count() -> int:
    return _STATE.get("num_processes", 1)


def process_index() -> int:
    return _STATE.get("process_id", 0)


def process_grid_slice(g: int, process_id: Optional[int] = None,
                       num_processes: Optional[int] = None) -> slice:
    """This process's contiguous slice of a flattened grid axis of size
    ``g``: rows [i*ceil(g/P), min((i+1)*ceil(g/P), g)).  Process-major and
    deterministic, so P processes partition the axis exactly; the
    defaults come from ``initialize_multiprocess`` (one process before
    it)."""
    p = process_count() if num_processes is None else int(num_processes)
    i = process_index() if process_id is None else int(process_id)
    if not 0 <= i < p:
        raise ValueError(f"process {i} outside [0, {p})")
    per = -(-g // p)
    return slice(min(i * per, g), min((i + 1) * per, g))


def _store():
    store = _STATE.get("store")
    if store is None:
        raise RuntimeError("the multi-process store is not initialized; "
                           "call initialize_multiprocess first")
    return store


def kv_put(key: str, value: str) -> None:
    """Publish a string under ``key`` in the cluster's key-value store."""
    _store().set(key, value)


def kv_get(key: str, timeout_s: float = 60.0) -> str:
    """Block until some process publishes ``key`` (at most ``timeout_s``
    seconds: then a ``torch.distributed.DistStoreError``); its value."""
    store = _store()
    store.wait([key], datetime.timedelta(seconds=timeout_s))
    return store.get(key).decode()
