"""String registry of Task factories, ported from ``repro.tasks.registry``.

Factories, not instances: ``get("paper_mlp", hidden=16)`` builds a fresh
Task with the overrides applied, so tests can shrink a workload without a
parallel config system.  Each registration records which runtime consumes
the bundle ("fleet" for ``run_fleet_task`` workloads, "steps" for the LM
train step of ``launch.train``), so a consumer can refuse a task it cannot
run before building it.  ``NOT_PORTED`` names the reference's tasks the
port does not have, with where ROADMAP.md queues them; every task of the
reference is ported now.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

from repro_torch.tasks.base import Task

_FACTORIES: Dict[str, Tuple[Callable[..., Task], str]] = {}

# the reference's tasks that are not ported yet, and where ROADMAP.md
# queues them
NOT_PORTED: Dict[str, str] = {}


def register(name: str, factory: Callable[..., Task],
             runtime: str = "fleet") -> None:
    if name in _FACTORIES:
        raise ValueError(f"task {name!r} already registered")
    _FACTORIES[name] = (factory, runtime)


def get(name: str, *, expect_runtime: Optional[str] = None,
        **overrides) -> Task:
    """Build the named task, passing ``overrides`` to its factory.

    ``expect_runtime`` is checked against the REGISTERED runtime before the
    factory runs, so a mismatched task fails with this message rather than
    a factory TypeError on runtime-specific overrides.
    """
    if name not in _FACTORIES:
        if name in NOT_PORTED:
            raise KeyError(f"task {name!r} is not ported yet; see "
                           f"{NOT_PORTED[name]}; available: {names()}")
        raise KeyError(f"unknown task {name!r}; available: {names()}; not "
                       f"ported yet (see ROADMAP.md): {sorted(NOT_PORTED)}")
    factory, runtime = _FACTORIES[name]
    if expect_runtime is not None and runtime != expect_runtime:
        raise ValueError(
            f"task {name!r} is a {runtime!r}-runtime workload; this "
            f"consumer needs one of {names(runtime=expect_runtime)}")
    task = factory(**overrides)
    if task.name != name:
        raise ValueError(f"factory for {name!r} built task {task.name!r}")
    if task.runtime != runtime:
        raise ValueError(f"task {name!r} declares runtime "
                         f"{task.runtime!r} but registered as {runtime!r}")
    return task


def names(runtime: Optional[str] = None) -> tuple:
    """Registered task names, optionally only those a runtime can consume."""
    return tuple(sorted(n for n, (_, rt) in _FACTORIES.items()
                        if runtime is None or rt == runtime))
