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

Model sharding (module 12b), the rules half of ``repro.distributed``:
model code annotates activations with *logical* axes (("batch", "seq",
None)); ``bind`` / ``mesh_rules`` bind a mesh of ranks
(``launch.mesh.ShardMesh``, a ``DeviceMesh`` with its axis names) and the
rules that map logical axes to mesh axes (``DEFAULT_RULES``);
``constrain`` then redistributes a DTensor to the placements they give,
and is a no-op with no mesh bound or on a plain tensor, so the same model
code serves one card and a mesh.  ``shard_map`` is DTensor's
``local_map`` with placements from specs.

The mesh's ranks are simulated in one process: ``simulated_world(n)``
opens PyTorch's fake process group of n ranks (collectives return at once)
and stands as rank 0, which is the dry-run's view of a production mesh on
fake tensors; ``simulated_world(n, local=True)`` also enters
``LocalTensorMode(n)``, under which every tensor holds one value per rank
and every op and collective runs for all n ranks, for real, on the CPU or
on one card.  ``per_rank`` hands each rank's plain tensors to a function
that cannot take the simulated ones (a kernel's ctypes launch).
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import logging
import os
import threading
from typing import Callable, Optional, Sequence

import torch

from repro_torch.launch import mesh as mesh_mod

_STATE: dict = {}
_RULES = threading.local()

DEFAULT_RULES = {
    "batch": ("data",),
    "batch_pod": ("pod", "data"),
    "seq": None,
    "kv_seq": None,         # overridden to ("data",) for long-context decode
    "heads": ("model",),
    "ff": ("model",),
    "embed": None,
    "vocab": ("model",),
    "expert": None,
}


def bind(mesh, rules: Optional[dict] = None) -> None:
    _RULES.mesh = mesh
    _RULES.rules = dict(DEFAULT_RULES)
    if rules:
        _RULES.rules.update(rules)


def unbind() -> None:
    _RULES.mesh = None
    _RULES.rules = None


@contextlib.contextmanager
def mesh_rules(mesh, rules: Optional[dict] = None):
    prev = (getattr(_RULES, "mesh", None), getattr(_RULES, "rules", None))
    bind(mesh, rules)
    try:
        yield
    finally:
        _RULES.mesh, _RULES.rules = prev


def active_mesh():
    return getattr(_RULES, "mesh", None)


def logical_to_spec(logical):
    """The spec (``models.param.P``) of logical axes under the bound rules
    (the defaults when none are bound): each logical axis's mesh axes,
    those present in the bound mesh (all of them with none bound)."""
    from repro_torch.models.param import P
    rules = getattr(_RULES, "rules", None) or DEFAULT_RULES
    mesh = active_mesh()
    axes = []
    for ax in logical:
        mapped = rules.get(ax) if isinstance(ax, str) else ax
        if mapped is None:
            axes.append(None)
            continue
        if isinstance(mapped, str):
            mapped = (mapped,)
        present = tuple(a for a in mapped if mesh is None
                        or a in mesh.axis_names)
        axes.append(present if present else None)
    return P(*axes)


def batch_logical() -> str:
    """'batch' or 'batch_pod' depending on the bound mesh."""
    mesh = active_mesh()
    if mesh is not None and "pod" in mesh.axis_names:
        return "batch_pod"
    return "batch"


def placements(mesh, spec, partial: Sequence[str] = ()) -> tuple:
    """DTensor placements over ``mesh``'s axes of a spec (one entry per
    tensor dim: None, an axis name or a tuple of them): Shard(dim) on each
    mesh axis a dim names, Partial() on the axes in ``partial``, else
    Replicate().  A dim over several axes is split over them in the mesh's
    axis order, major first, as the reference's tuple axes are."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    out = []
    for name in mesh.axis_names:
        dims = [d for d, ax in enumerate(spec) if ax is not None and (
            ax == name if isinstance(ax, str) else name in ax)]
        if len(dims) > 1:
            raise ValueError(f"spec {spec}: axis {name!r} on dims {dims}")
        if dims and name in partial:
            raise ValueError(f"axis {name!r} both sharded and partial")
        out.append(Shard(dims[0]) if dims else
                   Partial() if name in partial else Replicate())
    return tuple(out)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, logical):
    """Redistribute the DTensor ``x`` to the placements that its logical
    axes map to on the bound mesh; ``x`` itself with no mesh bound or when
    it is a plain tensor."""
    mesh = active_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    spec = []
    for n, ax in zip(x.shape, logical_to_spec(logical)):
        size = 1
        for a in ((ax,) if isinstance(ax, str) else ax or ()):
            size *= mesh.shape[a]
        # a dim its axes do not divide stays whole (the reference's XLA
        # would pad it): a batch of 1 on a data axis of 16
        spec.append(ax if n % size == 0 else None)
    want = placements(mesh, spec)
    return x if tuple(x.placements) == want \
        else x.redistribute(mesh.device_mesh, want)


@dataclasses.dataclass(frozen=True)
class Layout:
    """A spec with partial axes: a tensor laid out as ``spec`` whose value
    is the sum over the mesh axes in ``partial`` of its local tensors."""
    spec: tuple
    partial: tuple = ()


def _placements_of(mesh, layout) -> Optional[tuple]:
    if layout is None:
        return None
    if isinstance(layout, Layout):
        return placements(mesh, layout.spec, layout.partial)
    return placements(mesh, layout)


def shard_map(f: Callable, mesh, in_specs, out_specs,
              in_grad_specs=None) -> Callable:
    """DTensor's ``local_map`` of ``f`` over ``mesh``: each DTensor argument
    is handed to ``f`` as its local tensor, laid out as its entry of
    ``in_specs`` says (None for an argument that is not a tensor), and
    each output comes back a DTensor laid out as ``out_specs`` says (one
    entry, or a tuple of them for a tuple of outputs).  An entry is a spec
    (``models.param.P``) or a ``Layout`` with partial axes.
    ``in_grad_specs`` gives each input's gradient layout where it differs
    from the input's: a partial sum over the axes that ``f`` splits its
    work over and the input is replicated on."""
    from torch.distributed.tensor.experimental import local_map

    def many(entries):
        return None if entries is None else tuple(
            _placements_of(mesh, e) for e in entries)

    from repro_torch.models.param import P
    single = out_specs is None or isinstance(out_specs, (Layout, P))
    # local_map reads a tuple as one placement list per output
    outs = list(_placements_of(mesh, out_specs)) if single \
        else tuple(list(p) for p in many(out_specs))
    return local_map(f, out_placements=outs, in_placements=many(in_specs),
                     in_grad_placements=many(in_grad_specs),
                     device_mesh=mesh.device_mesh)


@contextlib.contextmanager
def simulated_world(n: int, local: bool = False):
    """A world of ``n`` ranks in this process: PyTorch's fake process
    group (every collective returns at once), this process standing as
    rank 0; with ``local``, ``LocalTensorMode(n)`` too, under which every
    rank computes and every collective is carried out.  A process group
    that is already open (``initialize_multiprocess``'s store makes none)
    is refused rather than replaced; on exit the group is destroyed and
    the mode left, whatever happened inside."""
    import torch.distributed as tdist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if tdist.is_initialized():
        raise RuntimeError("a process group is already open in this process")
    tdist.init_process_group("fake", world_size=int(n), rank=0,
                             store=FakeStore())
    # DTensor warns at each redistribution over two batch axes that one
    # collective over their flattened axis would be faster: the pod mesh's
    # every step
    log = logging.getLogger("torch.distributed.tensor._redistribute")
    level = log.level
    log.setLevel(logging.ERROR)
    try:
        if local:
            from torch.distributed._local_tensor import LocalTensorMode
            with LocalTensorMode(int(n)):
                yield
        else:
            yield
    finally:
        log.setLevel(level)
        tdist.destroy_process_group()


def local_mode():
    """The open ``LocalTensorMode``, or None."""
    from torch.distributed._local_tensor import enabled_local_tensor_mode
    return enabled_local_tensor_mode()


def per_rank(fn: Callable) -> Callable:
    """``fn`` called once per simulated rank on that rank's plain tensors
    (and ints) when a ``LocalTensorMode`` is open, its results gathered
    back into simulated tensors; ``fn`` itself otherwise.  For what cannot
    take a simulated tensor: a kernel's ctypes launch reads a data
    pointer, so under ``simulated_world(n, local=True)`` it launches n
    times, once for each rank's shard."""
    from torch.distributed._local_tensor import maybe_run_for_local_tensor
    return maybe_run_for_local_tensor(fn)


def _shard_slices(shape, mesh_shape, placements, idx) -> tuple:
    """The slices of a tensor of ``shape`` that the rank at mesh coordinate
    ``idx`` holds under ``placements`` (no partial one): each ``Shard``, in
    the mesh's dim order, cuts the piece before it as ``torch.chunk``
    does, which is how DTensor cuts it."""
    from torch.distributed.tensor import Shard
    lo, n = [0] * len(shape), list(shape)
    for md, pl in enumerate(placements):
        if isinstance(pl, Shard):
            d, m = pl.dim % len(shape), mesh_shape[md]
            c = -(-n[d] // m)
            a = min(idx[md] * c, n[d])
            lo[d], n[d] = lo[d] + a, min(c, n[d] - a)
    return tuple(slice(a, a + k) for a, k in zip(lo, n))


def _coords(ranks: torch.Tensor):
    """(mesh coordinate, rank) for every rank of a mesh's rank tensor."""
    import itertools
    for idx in itertools.product(*(range(n) for n in ranks.shape)):
        yield idx, int(ranks[idx])


def distribute(t: torch.Tensor, mesh, placements):
    """``t`` (whole, the same on every rank) as a DTensor of ``placements``
    on ``mesh`` (a ``ShardMesh``): each rank keeps its shard and nothing
    is sent.  Under ``LocalTensorMode`` a plain ``t`` is cut with the mode
    set aside, and every rank's local tensor is a copy of its own shard (a
    replicated one too), so that rank-dependent arithmetic and in-place
    updates act on each rank's copy, and no rank copies more than its
    shard (an op on a plain tensor under the mode runs once per rank:
    four whole copies of an expert weight of 6.4 GB on a mesh of four).
    ``assemble`` is the inverse."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    lm = local_mode()
    if lm is None or is_local(t):
        return distribute_tensor(t, mesh.device_mesh, placements,
                                 src_data_rank=None)
    ranks = mesh.device_mesh.mesh
    shards = {}
    with lm.disable():
        for idx, rank in _coords(ranks):
            shards[rank] = t[_shard_slices(t.shape, ranks.shape, placements,
                                           idx)].clone(
                memory_format=torch.contiguous_format)
    stride = [1] * t.dim()
    for d in range(t.dim() - 2, -1, -1):
        stride[d] = stride[d + 1] * t.shape[d + 1]
    return DTensor.from_local(lm.rank_map(lambda r: shards[r]),
                              mesh.device_mesh, placements, run_check=False,
                              shape=t.shape, stride=tuple(stride))


def assemble(x) -> torch.Tensor:
    """A DTensor (no partial placement) as one plain tensor.  Of simulated
    ranks, it is put together from each rank's own shard with
    ``LocalTensorMode`` set aside: under the mode ``full_tensor`` would
    all-gather a whole copy onto every rank, and an op on a plain tensor
    runs once per rank.  Use what it gives with the mode set aside
    (``local_mode().disable()``)."""
    loc = x.to_local()
    if not is_local(loc):
        return x.full_tensor()
    ranks, shards = x.device_mesh.mesh, loc._local_tensors
    lm = local_mode()
    with lm.disable() if lm is not None else contextlib.nullcontext():
        first = next(iter(shards.values()))
        out = torch.empty(tuple(x.shape), dtype=first.dtype,
                          device=first.device)
        for idx, rank in _coords(ranks):
            out[_shard_slices(x.shape, ranks.shape, x.placements,
                              idx)] = shards[rank]
    return out


def is_local(t) -> bool:
    """Whether ``t`` is a simulated tensor (one value per rank)."""
    from torch.distributed._local_tensor import LocalTensor
    return isinstance(t, LocalTensor)


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
