"""Fleet telemetry, ported from ``repro.telemetry``.  Three layers, all
opt-in:

``trace``        structured JSONL span/event writer (run id, monotonic
                 clocks, line-atomic appends, kill-and-resume pruning).
``diagnostics``  per-round Theorem-1 collectors: realized OTA bias power
                 and effective noise variance per cell, riding the
                 fleet's metric traces.
``report``       ``python -m repro_torch.telemetry.report <run_dir>``
                 renders the staging-overlap timeline, the solver summary,
                 the bias-variance trajectory, staleness histograms and
                 the recompilation audit.

The whole subsystem hangs off one knob: ``fl.driver.run_fleet(...,
telemetry=Telemetry(run_dir))`` (or a bare run-dir string).  Left at None,
no hook is set and a run is bitwise the run without this package.

The port runs eagerly: its chunks have no compile cache, so
``chunk_cache_size`` returns None for them and the driver emits no
``chunk_compile`` event.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

from repro_torch.telemetry.diagnostics import (DIAG_PREFIX, is_diagnostic,
                                               make_metrics_hook)
from repro_torch.telemetry.trace import EVENTS_FILE, Tracer, read_events

__all__ = [
    "DIAG_PREFIX", "EVENTS_FILE", "Telemetry", "Tracer",
    "assert_no_recompile", "chunk_cache_size", "is_diagnostic",
    "make_metrics_hook", "read_events",
]


@dataclasses.dataclass(frozen=True)
class Telemetry:
    """Telemetry configuration handed to ``fl.driver.run_fleet``.

    run_dir      where ``events.jsonl`` lives; the report tool reads the
                 same directory (put the fleet checkpoint next to it to
                 get the bias-variance trajectory in the report too).
    trace        emit the structured event stream (spans for chunk exec,
                 cohort staging, redesign, evals, checkpoint I/O, SCA
                 solves).
    diagnostics  add the ``bv_*`` Theorem-1 traces to every round's
                 metrics (recorded into FLResult.traces and any fleet
                 checkpoint; keep the setting across a kill-and-resume so
                 trace keys line up).
    kappa_sq     the paper's kappa^2, so the traced bias power is in the
                 SCA objective's units.

    Overhead: the diagnostics are a few [C]-sized reductions a round;
    tracing adds O(events) small host writes (the driver synchronizes the
    card at every chunk end with or without it) -- walls may shift, the
    numbers never do.
    """
    run_dir: str
    trace: bool = True
    diagnostics: bool = True
    kappa_sq: float = 1.0


def chunk_cache_size(chunk) -> Optional[int]:
    """Compiled-program cache size of a chunk that exposes one
    (``_cache_size()``), else None: the port's eager chunks have none."""
    fn = getattr(chunk, "_cache_size", None)
    return int(fn()) if callable(fn) else None


@contextlib.contextmanager
def assert_no_recompile(*chunks, allowed: int = 0):
    """Assert the compile caches of ``chunks`` grow by at most ``allowed``
    entries across the scope.  A chunk that exposes no compile cache
    (every eager chunk of the port) raises a ValueError: there is nothing
    to audit."""
    before = []
    for c in chunks:
        size = chunk_cache_size(c)
        if size is None:
            raise ValueError(f"{c!r} exposes no compile cache to audit")
        before.append(size)
    yield
    for c, b in zip(chunks, before):
        now = chunk_cache_size(c)
        if now - b > allowed:
            raise AssertionError(
                f"chunk recompiled: compile cache grew {b} -> {now} "
                f"(allowed growth {allowed}) for {c!r}")
