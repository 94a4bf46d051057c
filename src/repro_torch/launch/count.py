"""The dry-run's counting modes: what one step costs, from fake tensors.

``Count`` is one context, opened inside ``fake_mode()`` (a
``FakeTensorMode``: tensors with shapes, dtypes and a device but no
storage, so a step at full width and depth runs on the host's CPU and
allocates nothing; with ``card=True`` its fakes take the card's path
through the kernel wrappers whatever their device).  It holds three
counters:

* a ``torch.utils.flop_counter.FlopCounterMode``: matrix products,
  convolutions and SDPA, as PyTorch counts them (2 operations a
  multiply-add).  Like the reference's dry-run it counts no elementwise
  operation;
* a ``TorchDispatchMode`` that sums, for each aten op, the bytes of its
  tensor operands and of its results: the analog of XLA's "bytes
  accessed".  Views, aliases and metadata ops move nothing and count 0:
  ``view``, ``_unsafe_view``, ``reshape`` when it is a view (it reaches
  dispatch as ``view``; otherwise as a ``clone``, which counts),
  ``expand``, ``t``, ``transpose``, ``permute``, ``slice``, ``select``,
  ``unsqueeze``, ``squeeze``, ``detach``, ``alias``, ``as_strided`` and
  every other op whose schema returns a view; so do the allocations that
  write nothing (``empty``, ``empty_strided``, ``new_empty``,
  ``empty_like``) and the queries that return no tensor (``prim.device``,
  a size).  A tensor counts the elements it holds (an expanded operand's
  broadcast dims once: matmul may take one weight as mm or expanded to
  bmm, and moves the same bytes); an in-place op reads and writes its
  target.  As the reference's caveat says of XLA's count
  (``benchmarks/roofline.py``), this is an upper bound on device-memory
  traffic: every operand access counts, and no reuse in caches or
  shared memory, nor any fusion, is modeled;
* a tally of the collectives that a step on a mesh of ranks asks for
  (``models.sharded``: DTensor's functional collectives,
  ``_c10d_functional.*``), by the reference's names (``all-gather``,
  ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``) and ``total``: each op counted by the bytes of
  its result on one device, as ``repro/launch/hlo.py`` counts the result
  shapes of the HLO's collectives.  DTensor on a CPU mesh outside
  ``LocalTensorMode`` carries an all-to-all out as an all-gather and a
  chunk; it is counted as the all-to-all it stands for, by the chunk.
  Collectives move bytes between devices, not through one's memory, and
  are not in the bytes above;
* a tally of kernel calls by kernel (``calls``, ``flops``, ``bytes``): a
  kernel wrapper that meets a fake input on the card's path (``on_card``)
  launches nothing and adds its ``work(...)`` here instead (``kernels.flash_attention.work``,
  ``kernels.ssd_scan.work``: each input read once, each output written
  once, the products of the pairs the masks allow), which the totals
  include.

The records are not held to the reference's HLO numbers: XLA counts the
program it compiled for a TPU mesh (fused, sharded, rematerialized, its
attention in another form), the port counts the ops its eager step
dispatches on one card, so the two differ by construction; the
parameter counts and the model FLOPs they are read against are the
same (``repro_torch.roofline``).
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

_aten = torch.ops.aten
# op packets that move no bytes: views, aliases, metadata, and allocations
# that write nothing (any other op whose schema returns a view also counts
# 0: ``OpOverload.is_view``)
FREE_OPS = frozenset({
    _aten.view, _aten._unsafe_view, _aten.expand, _aten.t, _aten.transpose,
    _aten.permute, _aten.slice, _aten.select, _aten.unsqueeze,
    _aten.squeeze, _aten.detach, _aten.alias, _aten.as_strided,
    _aten.empty, _aten.empty_strided, _aten.new_empty, _aten.empty_like,
    _aten.lift_fresh})

_OPEN: list = []            # the open Counts, innermost last
_FAKING: list = []          # the open fake_mode()s' ``card`` flags
_INSIDE: list = []          # an all-to-all's fallback in progress
_PATCHED: list = []         # the patched fallback's original
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# DTensor's functional collectives by the reference's names
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
}


@contextlib.contextmanager
def fake_mode(card: bool = False):
    """A ``FakeTensorMode`` (real tensors that enter it, such as a scheme's
    design leaves, become fakes).  ``card``: its fakes stand for tensors
    on the card whatever their device, so the kernel wrappers take the
    card's path on them (``on_card``) and count it: a build of PyTorch
    without CUDA cannot run every op (an index, autograd) on fake CUDA
    tensors, so there the dry-run makes its fakes on the CPU."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        _FAKING.append(card)
        try:
            yield mode
        finally:
            _FAKING.pop()


def faking() -> bool:
    """Whether a ``fake_mode()`` is open."""
    return bool(_FAKING)


def is_fake(t: torch.Tensor) -> bool:
    """Whether ``t`` is a fake tensor: shapes without storage, which a
    kernel wrapper counts and never launches."""
    from torch._subclasses.fake_tensor import is_fake as fake
    return fake(t)


def on_card(t: torch.Tensor) -> bool:
    """Whether a kernel wrapper takes the card's path for ``t``: a CUDA
    tensor, or a fake inside ``fake_mode(card=True)``."""
    return t.is_cuda or bool(_FAKING and _FAKING[-1] and is_fake(t))


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        if x.numel() == 0:
            return 0
        n = x.element_size()
        for size, stride in zip(x.shape, x.stride()):
            n *= size if stride else 1      # a broadcast dim holds one
        return n
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    if isinstance(x, dict):
        return sum(_nbytes(v) for v in x.values())
    return 0


def _has_tensor(x) -> bool:
    if isinstance(x, torch.Tensor):
        return True
    if isinstance(x, (list, tuple)):
        return any(_has_tensor(v) for v in x)
    return False


class _Bytes(TorchDispatchMode):
    """Sums each aten op's tensor operand and result bytes."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace in ("_c10d_functional", "_dtensor"):
            name = _COLLECTIVE_OPS.get(func.overloadpacket.__name__)
            if name is not None and not _INSIDE:
                for c in _OPEN:
                    c.add_collective(name, out)
            return out
        if not (func.overloadpacket in FREE_OPS or func.is_view
                or not _has_tensor(out)):
            # an ``out=`` tensor is the result: counted once, as written
            self.total += (_nbytes(args) + _nbytes(
                {k: v for k, v in kwargs.items() if k != "out"})
                + _nbytes(out))
        return out


class Count:
    """FLOPs, bytes and the kernel tally of what runs while it is open
    (see the module's docstring).  ``report()`` gives them; nested Counts
    each count everything run inside them."""

    def __init__(self):
        self._flops = FlopCounterMode(display=False)
        self._bytes = _Bytes()
        self.kernels: dict = {}
        self.collectives: dict = dict.fromkeys(COLLECTIVES, 0)
        self.collective_calls: dict = dict.fromkeys(COLLECTIVES, 0)
        # (bytes, op, result shape, dtype) of each collective, in order
        self.collective_log: list = []

    def __enter__(self) -> "Count":
        self._flops.__enter__()
        self._bytes.__enter__()
        if not _OPEN:
            _patch_alltoall()
        _OPEN.append(self)
        return self

    def __exit__(self, *exc):
        _OPEN.remove(self)
        if not _OPEN:
            _unpatch_alltoall()
        self._bytes.__exit__(*exc)
        self._flops.__exit__(*exc)
        return False

    def add_collective(self, name: str, out) -> None:
        """One collective ``name`` whose result on this device is ``out``."""
        n = _nbytes(out)
        self.collectives[name] += n
        self.collective_calls[name] += 1
        self.collective_log.append((n, name, tuple(out.shape),
                                    str(out.dtype).replace("torch.", "")))

    def add(self, kernel: str, work: dict) -> None:
        """One call of ``kernel`` doing ``work`` ({"flops", "bytes"})."""
        t = self.kernels.setdefault(kernel,
                                    {"calls": 0, "flops": 0, "bytes": 0})
        t["calls"] += 1
        t["flops"] += int(work["flops"])
        t["bytes"] += int(work["bytes"])

    @property
    def flops(self) -> int:
        return int(self._flops.get_total_flops()) + sum(
            t["flops"] for t in self.kernels.values())

    @property
    def bytes(self) -> int:
        return self._bytes.total + sum(
            t["bytes"] for t in self.kernels.values())

    def report(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "collectives": {**self.collectives,
                                "total": sum(self.collectives.values())},
                "collective_calls": dict(self.collective_calls)}


def _patch_alltoall() -> None:
    """Count DTensor's all-to-all as one, where a CPU mesh carries it out
    as an all-gather and a chunk (``shard_dim_alltoall``)."""
    try:
        from torch.distributed.tensor import placement_types as pt
    except ImportError:         # a build without torch.distributed
        return
    orig = getattr(pt, "shard_dim_alltoall", None)
    if orig is None:
        return

    def counted(input, gather_dim, shard_dim, mesh, mesh_dim):
        _INSIDE.append(True)
        try:
            out = orig(input, gather_dim, shard_dim, mesh, mesh_dim)
        finally:
            _INSIDE.pop()
        for c in _OPEN:
            c.add_collective("all-to-all", out)
        return out

    _PATCHED.append(orig)
    pt.shard_dim_alltoall = counted


def _unpatch_alltoall() -> None:
    if _PATCHED:
        from torch.distributed.tensor import placement_types as pt
        pt.shard_dim_alltoall = _PATCHED.pop()


def add_kernel(kernel: str, work: dict) -> None:
    """Tally one call of ``kernel`` on fake inputs in every open Count;
    with none open, raise: a fake tensor reaches a kernel only in a
    dry-run, which counts it."""
    if not _OPEN:
        raise RuntimeError(
            f"{kernel} got fake tensors with no launch.count.Count open: "
            "a fake input launches nothing, and is counted only inside a "
            "Count (python -m repro_torch.launch.dryrun)")
    for c in _OPEN:
        c.add(kernel, work)
