"""Structured JSONL event tracing, a copy of ``repro.telemetry.trace``
(the port keeps its own: it imports nothing of the JAX package).

One run directory holds one ``events.jsonl``: a flat, append-only stream
of events, one JSON object per line.  Every event carries the run id, a
wall clock (``wall``, epoch seconds — for humans and cross-process
ordering) and a monotonic clock (``mono`` — for in-process durations;
span events additionally carry ``dur``, measured monotonically so NTP
steps can never produce negative spans).

Appends are line-atomic by construction: each event is a single
``write()`` of one ``\\n``-terminated line to a file opened with
``O_APPEND``, behind a process-wide lock — the streaming driver's staging
worker and the main chunk loop interleave whole lines, never bytes.  A
kill can at worst truncate the final line; the resume path drops partial
trailing lines.

Kill-and-resume contract: ``Tracer(run_dir, fresh=False)`` re-opens an
existing log preserving its run id, and ``resume(start_chunk)`` prunes it
to exactly the events of completed chunks — every event tagged with
``chunk >= start_chunk`` is dropped (those chunks re-run and re-emit),
untagged non-lifecycle events are dropped too (they cannot be attributed,
so they may not be double-counted), and a ``run_resume`` marker is
appended.  A resumed run therefore produces ONE consistent log: no
duplicated chunk spans, no lost completed spans, a single run id.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import uuid
from typing import List, Optional

EVENTS_FILE = "events.jsonl"

# lifecycle events survive resume pruning even though they carry no chunk
# tag: they record the history of the run, not per-chunk work
_LIFECYCLE = ("run_start", "run_resume")


def _jsonify(obj):
    """json.dumps default= hook: numpy scalars/arrays -> python."""
    if hasattr(obj, "tolist"):
        return obj.tolist()
    if hasattr(obj, "item"):
        return obj.item()
    return str(obj)


def read_events(path: str) -> List[dict]:
    """Parse an events.jsonl (or the run dir holding one) into a list,
    skipping partial (killed-mid-write) lines."""
    if os.path.isdir(path):
        path = os.path.join(path, EVENTS_FILE)
    out = []
    with open(path) as f:
        for line in f:
            if not line.endswith("\n"):
                continue                   # partial trailing line
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


class Tracer:
    """Low-overhead span/event writer for one run directory.

    fresh=True   truncate any existing log and start a new run id.
    fresh=False  re-open the existing log (kill-and-resume): the run id
                 is read back from its ``run_start`` line; call
                 ``resume(start_chunk)`` once the driver knows which
                 chunk it fast-forwarded to.  A missing log degrades to
                 a fresh start.
    """

    def __init__(self, run_dir: str, fresh: bool = True):
        os.makedirs(run_dir, exist_ok=True)
        self.run_dir = run_dir
        self.path = os.path.join(run_dir, EVENTS_FILE)
        self._lock = threading.Lock()
        self._local = threading.local()
        self.run_id: Optional[str] = None
        if not fresh or not os.path.exists(self.path):
            if os.path.exists(self.path):
                for ev in read_events(self.path):
                    if ev.get("ev") == "run_start":
                        self.run_id = ev.get("run")
                        break
        if self.run_id is None:
            self.run_id = uuid.uuid4().hex[:12]
            with open(self.path, "w"):
                pass                       # truncate: this is a new run
            self.event("run_start")

    # -- context tags -------------------------------------------------------

    @contextlib.contextmanager
    def ctx(self, **fields):
        """Thread-local default fields merged into every event emitted
        inside the scope — how the driver tags solver events fired deep
        inside a staging thread with the chunk they belong to."""
        old = getattr(self._local, "ctx", {})
        self._local.ctx = {**old, **fields}
        try:
            yield
        finally:
            self._local.ctx = old

    # -- emission -----------------------------------------------------------

    def event(self, kind: str, **fields) -> None:
        rec = {"ev": kind, "run": self.run_id,
               **getattr(self._local, "ctx", {}), **fields}
        rec["wall"] = round(time.time(), 6)
        rec["mono"] = round(time.monotonic(), 6)
        line = json.dumps(rec, default=_jsonify) + "\n"
        with self._lock:
            with open(self.path, "a") as f:
                f.write(line)

    @contextlib.contextmanager
    def span(self, kind: str, **fields):
        """Emit ``kind`` with a monotonic ``dur`` on scope exit."""
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.event(kind, dur=round(time.monotonic() - t0, 6), **fields)

    # -- resume -------------------------------------------------------------

    def resume(self, start_chunk: int) -> None:
        """Prune the re-opened log to completed chunks (< ``start_chunk``)
        and mark the resume.  Atomic: the pruned log replaces the old one
        via ``os.replace``, so a kill during pruning loses nothing."""
        kept = [ev for ev in read_events(self.path)
                if ev.get("ev") in _LIFECYCLE
                or (isinstance(ev.get("chunk"), int)
                    and ev["chunk"] < start_chunk)]
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            for ev in kept:
                f.write(json.dumps(ev, default=_jsonify) + "\n")
        os.replace(tmp, self.path)
        self.event("run_resume", start_chunk=int(start_chunk))
