"""Parameter definitions for the port's models.

Parameters are a plain ``dict`` of tensors.  Every function that ravels
them walks the keys in sorted order, which is ``jax.tree.flatten``'s order
for a dict: for the MLP that is ``b1, b2, w1, w2``.  The per-leaf noise
draws and the raveled gradient line up with the reference only in that
order.

``init_params`` draws the ``scaled`` law of ``repro.models.param``
(normal x 1/sqrt(fan_in), zeros for biases) from a ``torch.Generator``; it
cannot reproduce JAX's threefry stream, so weights are carried across with
``params_from_jax`` where a test needs the reference's exact start.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple
    init: str = "scaled"          # scaled | zeros
    fan_in: Optional[int] = None  # for 'scaled': 1/sqrt(fan_in)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1


def param_count(defs: Mapping[str, ParamDef]) -> int:
    return sum(d.size for d in defs.values())


def leaf_order(tree: Mapping) -> list:
    """The raveling order of a parameter dict: sorted keys."""
    return sorted(tree)


def _init_one(d: ParamDef, gen: torch.Generator) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=torch.float32)
    if d.init != "scaled":
        raise ValueError(f"unknown init {d.init!r}")
    fan_in = d.fan_in if d.fan_in is not None else d.shape[-2]
    scale = 1.0 / math.sqrt(fan_in)
    return torch.randn(d.shape, generator=gen, dtype=torch.float32) * scale


def init_params(defs: Mapping[str, ParamDef], seed: int,
                device: torch.device) -> dict:
    """Materialize ``defs`` from a CPU generator seeded with ``seed`` (the
    same numbers on every device), leaves drawn in raveling order."""
    gen = torch.Generator().manual_seed(int(seed))
    return {k: _init_one(defs[k], gen).to(device) for k in leaf_order(defs)}


def params_from_jax(tree: Mapping[str, np.ndarray],
                    device: torch.device = torch.device("cpu")) -> dict:
    """Carry a reference parameter dict (leaves converted to numpy by the
    caller) across as float32 tensors, bit for bit."""
    return {k: torch.from_numpy(np.array(tree[k], np.float32)).to(device)
            for k in leaf_order(tree)}
