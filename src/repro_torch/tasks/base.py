"""The Task bundle: one FL workload as data x model x eval, ported from
``repro.tasks.base`` for the paper task.

    build_data(seed) -> TaskData     deterministic numpy data, non-iid split
    init_params(seed, device)        the task's ParamDef dict, drawn from a
                                     torch.Generator seeded with ``seed``
    loss_fn(params, batch)           one device's loss on one cell's params
    make_eval(td, device)(params)    {name: scalar} on one cell's params
    run_config(**overrides)          the task's FLRunConfig
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.fl.server import FLRunConfig
from repro_torch.models.param import init_params


@dataclasses.dataclass(frozen=True)
class TaskData:
    """A materialized workload instance (one ``build_data(seed)`` call).

    train   stacked per-device arrays (x [N, Dn, ...], y [N, Dn]), numpy
    test    held-out (x, y), numpy
    extras  task-specific payloads (e.g. the global-loss subsample)
    """
    train: Any
    test: Any = None
    extras: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class Task:
    name: str
    num_devices: int
    param_dim: int                       # d in the paper's OTA math
    loss_fn: Callable                    # (params, batch) -> scalar
    defaults: dict                       # FLRunConfig kwargs
    defs: dict                           # ParamDef per leaf
    _build_data: Callable                # (seed) -> TaskData
    _make_eval: Callable                 # (TaskData, device) -> eval_fn
    scheme_etas: dict = dataclasses.field(default_factory=dict)
    artifact_tag: str = ""

    def build_data(self, seed: int = 0) -> TaskData:
        return self._build_data(seed)

    def init_params(self, seed: int, device: torch.device) -> dict:
        return init_params(self.defs, seed, device)

    def make_eval(self, td: TaskData, device: torch.device):
        return self._make_eval(td, device)

    def run_config(self, **overrides):
        kw = dict(self.defaults)
        kw.update(overrides)
        return FLRunConfig(**kw)

    def eta_for(self, scheme_name: str, default: float) -> float:
        """Per-scheme step size; schemes without an entry use ``default``."""
        return float(self.scheme_etas.get(scheme_name, default))
