"""Placement of the fleet's cells on device slots, ported from
``repro.fl.placement``.

The fleet is three layers: the round (``fl.engine.make_round_body``), the
placement (this module), which maps the flattened [K scheme x S seed] cell
axis onto slots and runs a chunk of rounds there, and the host driver
(``fl.driver``: the chunk loop, the adaptive redesign, the checkpoint),
which sees every placement through the same interface:

    build_chunk(body) -> chunk
        chunk(schemes, eta, params_b, fstate, draws, t0, data, cell_seed,
              length, proc=None, cohort=None, grid=(K, S))
        -> (params_b, fstate, metrics)

``length`` rounds from round ``t0``: ``eta`` [C] and ``params_b`` (leaves
[C, ...]) are the whole grid's, ``fstate`` the fading state [R, S, N] (or
None), ``draws`` the provider (t -> the round's draws), ``data`` the
device shards, ``proc`` the channel process, ``cohort`` population mode's
operands; ``metrics`` is one dict of [C] traces per round.  Everything
comes back gathered on the device ``params_b`` came from, the grid axes
restored, so the evals, the adaptive redesign, the population table's
commit and the checkpoint read the same tensors whatever ran the cells.

``VmapPlacement`` is the one-device fleet: the rounds over all C cells at
once, exactly the launches and the numbers of the fleet before placements
existed.  ``ShardedPlacement`` cuts the cell axis into one contiguous block
per slot of a mesh (``launch.mesh``; several slots may share a card),
padding it with copies of cell 0 to a multiple of the slot count, as
``distributed.shard_vmap`` does; each slot runs the chunk's rounds on its
own block on its own device, one round-tail launch a slot a round.

Where the reference builds three programs (plain, cohort and scenario
chunks) and takes ``adaptive`` and ``tracer`` to lay out the design leaves
and to report compiles, the port's chunk is one eager loop: the round
body takes every kind's operands itself, a scheme's design leaves keep
their own seed axis (a block gathers its cells' rows, so the reference's
``prepare_schemes`` has no counterpart), and nothing is compiled, so
``build_chunk`` takes the body alone and no ``chunk_compile`` is emitted.  The reference's ``donate`` (XLA's buffer aliasing of the
carries) has no counterpart either: a round replaces its tensors and the
old ones are freed when their references drop, on every placement.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import distributed
from repro_torch.launch.mesh import grid_axes


class Placement:
    """Interface; see the module docstring for the contract."""

    def build_chunk(self, body: Callable) -> Callable:
        raise NotImplementedError

    def compile_batch(self, fn: Callable) -> Callable:
        """``fn``, batched over a leading [B] axis, as this placement runs
        it."""
        raise NotImplementedError

    def map_batch(self, fn: Callable, batch_tree):
        return self.compile_batch(fn)(batch_tree)

    def describe(self, cells=None) -> str:
        """Stable identity string, recorded in fleet checkpoints so that a
        resume on another placement is refused (the bitwise-resume
        contract holds per placement).  ``cells`` (the flattened grid's
        size) lets a padding placement report its padding."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class VmapPlacement(Placement):
    """The one-device fleet: every round over all C cells at once."""

    def build_chunk(self, body: Callable) -> Callable:
        def chunk(schemes, eta, params_b, fstate, draws, t0, data,
                  cell_seed, length, proc=None, cohort=None, grid=None):
            metrics = []
            for t in range(t0, t0 + length):
                params_b, fstate, m = body(schemes, eta, params_b, fstate,
                                           draws(t), data, cell_seed, proc,
                                           cohort)
                metrics.append(m)
            return params_b, fstate, metrics
        return chunk

    def compile_batch(self, fn: Callable) -> Callable:
        return fn

    def describe(self, cells=None) -> str:
        return "vmap"


@dataclasses.dataclass(frozen=True)
class ShardedPlacement(Placement):
    """The flattened [K * S] cell axis sharded over the slots of ``mesh``'s
    ``axes`` (default: every axis; fleet cells are independent, so "data"
    and "model" both serve as cell slots).

    A chunk pads the grid with copies of cell 0 to a multiple of the slot
    count and gives slot i the contiguous block of cells [i P', (i + 1)
    P'), P' = C_padded / slots.  Each block runs the chunk's rounds on its
    slot's device through the round body's block form (``cell_scheme``):
    its params and step sizes, its cells' seed rows and schemes.  Then the
    params and the traces are gathered on the driver's device and the
    padding sliced off.

    Draws: one set a round, made by the driver's provider on its device
    and copied to each slot's device (a no-op where the slots share the
    card).  ``DeviceDraws`` reseeds its generator per (seed, round), so
    drawing a block's seeds on its own device would give the same numbers;
    copying keeps one provider and one draw a round whatever the slot
    count.  On the paper's d that is S x 3.26 MB of z a round a slot
    across cards, nothing on one card.

    The fading state: [R, S, N], one row per seed, shared by that seed's
    schemes.  Every block steps the WHOLE state from the same state on the
    same innovations (R x S x N elements, a few kB), so the copies stay
    bitwise equal; at the chunk's end they are compared (``torch.equal``,
    one check a chunk; a difference raises) and the first slot's is
    returned.  The adaptive redesign therefore reads exactly the state
    the vmap placement gives it.

    Cohort operands ([S, N]) and a scenario stack's rows ([R, ...]) go to
    every slot whole; each block takes its cells' rows through its cells'
    seed rows and schemes, as the reference tiles them to the cell axis.
    """
    mesh: Any
    axes: tuple = None               # default: every axis of ``mesh``

    def __post_init__(self):
        if self.axes is None:
            object.__setattr__(self, "axes", grid_axes(self.mesh))
        object.__setattr__(self, "axes", tuple(self.axes))

    @property
    def num_devices(self) -> int:
        """The slots the cell axis shards over (several may share a
        card)."""
        return distributed.grid_devices(self.mesh, self.axes)

    @property
    def slots(self) -> list:
        return distributed.grid_slots(self.mesh, self.axes)

    def pad(self, cells: int):
        """(padded grid size, padded-cell fraction) for a flattened grid
        of ``cells`` cells (the reference's ``_pad``): the cell-0 copies that make it divide the slot
        count."""
        n = self.num_devices
        gp = -(-cells // n) * n
        return gp, (gp - cells) / gp

    def blocks(self, k: int, s: int) -> list:
        """[(slot, cell indices)] of a [K, S] grid: cell c is scheme
        c // S, seed c % S; padded cells are cell 0."""
        c = k * s
        gp, _ = self.pad(c)
        cells = np.concatenate([np.arange(c), np.zeros(gp - c, np.int64)])
        per = gp // self.num_devices
        return [(dev, cells[i * per:(i + 1) * per])
                for i, dev in enumerate(self.slots)]

    def build_chunk(self, body: Callable) -> Callable:
        layouts = {}

        def layout(k, s):
            key = (k, s)
            if key not in layouts:
                layouts[key] = [
                    (dev, ids, ids // s, torch.as_tensor(ids % s, device=dev))
                    for dev, ids in self.blocks(k, s)]
            return layouts[key]

        def chunk(schemes, eta, params_b, fstate, draws, t0, data,
                  cell_seed, length, proc=None, cohort=None, grid=None):
            k, s = grid
            c = k * s
            home = eta.device
            gp, _ = self.pad(c)
            eta_p, params_p = distributed.pad_rows((eta, params_b), c, gp)
            per = gp // self.num_devices
            state = []
            for i, (dev, _, scheme_of, seed_of) in enumerate(layout(k, s)):
                def to(a, dev=dev):
                    return a.to(dev)
                cut = slice(i * per, (i + 1) * per)
                state.append({
                    "dev": dev, "scheme": scheme_of, "seed": seed_of,
                    "eta": eta_p[cut].to(dev),
                    "params": {n: v[cut].to(dev)
                               for n, v in params_p.items()},
                    "fstate": None if fstate is None else fstate.to(dev),
                    "data": distributed.tree_map(to, data),
                    "cohort": distributed.tree_map(to, cohort),
                    "metrics": []})
            for t in range(t0, t0 + length):
                drawn = draws(t)
                for b in state:
                    b["params"], b["fstate"], m = body(
                        schemes, b["eta"], b["params"], b["fstate"],
                        distributed.tree_map(lambda a, d=b["dev"]: a.to(d),
                                             drawn),
                        b["data"], b["seed"], proc, b["cohort"],
                        cell_scheme=b["scheme"])
                    b["metrics"].append(m)
            params_b = {n: torch.cat([b["params"][n].to(home)
                                      for b in state])[:c]
                        for n in params_b}
            if fstate is not None:
                fstate = state[0]["fstate"].to(home)
                for b in state[1:]:
                    if not torch.equal(b["fstate"].to(home), fstate):
                        raise RuntimeError(
                            f"the fading state of slot {b['dev']} left the "
                            "first slot's: blocks must step it bitwise alike")
            metrics = []
            if length:
                names = list(state[0]["metrics"][0])
                traces = {n: torch.cat([torch.stack(
                    [m[n] for m in b["metrics"]], dim=-1).to(home)
                    for b in state])[:c] for n in names}
                metrics = [{n: traces[n][:, r] for n in names}
                           for r in range(length)]
            return params_b, fstate, metrics
        return chunk

    def compile_batch(self, fn: Callable) -> Callable:
        return distributed.shard_vmap(fn, self.mesh, self.axes)

    def describe(self, cells=None) -> str:
        shape = ",".join(f"{a}={self.mesh.shape[a]}" for a in self.axes)
        if cells is None:
            return f"sharded[{shape}]"
        gp, _ = self.pad(int(cells))
        return (f"sharded[{shape},cells={int(cells)},"
                f"pad={gp - int(cells)}/{gp}]")
