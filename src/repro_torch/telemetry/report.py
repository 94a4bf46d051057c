"""Render a fleet run directory's telemetry, ported from
``repro.telemetry.report`` (on the same run dir it prints the same text,
byte for byte).

    PYTHONPATH=src python -m repro_torch.telemetry.report <run_dir>
        [--npz PATH] [--rounds N]

``run_dir`` holds the ``events.jsonl`` a ``telemetry=``-enabled
``fl.driver.run_fleet`` wrote (for ``repro_torch.fig2 --telemetry`` that
is the task's artifact dir, e.g. ``experiments/cifar``); a run dir the
reference wrote reads the same.  Sections:

  timeline     per-chunk staging-lane profile: stage wall, the visible
               wait on the double buffer, the latency hidden behind the
               previous chunk's execution, compile and exec walls — the
               stream-vs-serialized overlap story of ONE run, per chunk.
  solver       SCA redesign summary (count / iters / objective /
               convergence) from the ``sca_solve`` events the staging
               worker emits.
  bias--variance  per-scheme realized Theorem-1 trajectory from the
               ``bv_*`` diagnostic traces riding the newest fleet
               checkpoint in the run dir (``--npz`` overrides).
  staleness    cohort participation + re-entry staleness histograms from
               ``cohort`` events (per-device rounds-since-last-seen).
  recompiles   every ``chunk_compile`` span; lengths that compiled more
               than once are flagged — the recompilation audit.  The
               port runs eagerly and emits no ``chunk_compile``, so on
               its own run dirs this section says none was recorded.

Everything is plain text on stdout; the tool only reads the run dir.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys
from collections import defaultdict

import numpy as np

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.telemetry.trace import EVENTS_FILE, read_events

# staleness buckets: rounds since the drawn device last participated
_BUCKETS = ((0, 0, "0"), (1, 1, "1"), (2, 3, "2-3"), (4, 7, "4-7"),
            (8, np.inf, "8+"))


def _fmt_s(x) -> str:
    return "-" if x is None else f"{x:8.3f}"


def _bar(frac: float, width: int = 24) -> str:
    return "#" * int(round(frac * width))


def header(events) -> None:
    start = next((e for e in events if e["ev"] == "run_start"), None)
    cfg = next((e for e in events if e["ev"] == "fleet_config"), None)
    resumes = [e for e in events if e["ev"] == "run_resume"]
    end = next((e for e in reversed(events) if e["ev"] == "run_end"), None)
    print("run".ljust(12), start["run"] if start else "?")
    if cfg:
        print("fleet".ljust(12),
              f"{len(cfg.get('names', []))} schemes x "
              f"{len(cfg.get('seeds', []))} seeds, "
              f"{cfg.get('num_rounds')} rounds in {cfg.get('chunks')} chunks "
              f"on {cfg.get('placement')}")
        if cfg.get("scenarios"):
            print("scenarios".ljust(12),
                  f"{len(cfg['scenarios'])} stacked: "
                  + ", ".join(cfg["scenarios"]))
        if cfg.get("population"):
            print("population".ljust(12),
                  f"{cfg['population']} devices, cohort "
                  f"{cfg.get('cohort_size')}"
                  f" every {cfg.get('cohort_rounds') or 'chunk'} rounds, "
                  f"stream={cfg.get('stream')}")
    print("resumes".ljust(12), len(resumes),
          ("(at chunks " + ", ".join(str(e.get("start_chunk"))
                                     for e in resumes) + ")"
           if resumes else ""))
    if end:
        print("wall".ljust(12), f"{end.get('wall_s')}s "
              f"({end.get('rounds_done')} rounds, "
              f"{end.get('chunks_done')} chunks)")


def timeline(events) -> None:
    by_chunk: dict = defaultdict(dict)
    for e in events:
        ci = e.get("chunk")
        if not isinstance(ci, int):
            continue
        if e["ev"] == "stage":
            by_chunk[ci]["stage"] = e.get("dur")
            by_chunk[ci]["redesigned"] = e.get("redesigned")
        elif e["ev"] == "stage_wait":
            by_chunk[ci]["wait"] = e.get("dur")
        elif e["ev"] == "chunk_exec":
            by_chunk[ci]["exec"] = e.get("dur")
            by_chunk[ci]["length"] = e.get("length")
        elif e["ev"] == "chunk_compile":
            by_chunk[ci]["compile"] = e.get("dur")
        elif e["ev"] == "ckpt_save":
            by_chunk[ci]["ckpt"] = e.get("dur")
    if not by_chunk:
        print("(no chunk events)")
        return
    print("chunk  len   stage_s   wait_s  hidden_s compile_s    exec_s"
          "    ckpt_s")
    tot = defaultdict(float)
    for ci in sorted(by_chunk):
        row = by_chunk[ci]
        hidden = None
        if row.get("stage") is not None:
            # visible wait < full stage wall => the difference overlapped
            # the previous chunk's device execution (the streaming win);
            # chunks staged inline (no wait event: chunk 0, serialized
            # mode, first chunk after a resume) hid nothing
            hidden = max(row["stage"] - row["wait"], 0.0) \
                if row.get("wait") is not None else 0.0
        cells = [row.get("stage"), row.get("wait"), hidden,
                 row.get("compile"), row.get("exec"), row.get("ckpt")]
        for key, val in zip(("stage", "wait", "hidden", "compile", "exec",
                             "ckpt"), cells):
            if val is not None:
                tot[key] += val
        mark = " *" if row.get("redesigned") else ""
        print(f"{ci:5d} {row.get('length', 0):4d} "
              + " ".join(_fmt_s(c) for c in cells) + mark)
    print("total       "
          + " ".join(_fmt_s(tot.get(k)) for k in
                     ("stage", "wait", "hidden", "compile", "exec", "ckpt")))
    if tot.get("stage"):
        frac = tot["hidden"] / tot["stage"]
        print(f"staging overlap: {tot['hidden']:.3f}s of {tot['stage']:.3f}s"
              f" staging hidden behind execution ({100 * frac:.0f}%)"
              "  [* = cohort redesign in that stage]")


def solver(events) -> None:
    solves = [e for e in events if e["ev"] == "sca_solve"]
    if not solves:
        print("(no sca_solve events)")
        return
    durs = [e.get("dur", 0.0) for e in solves]
    objs = [e["objective_mean"] for e in solves if "objective_mean" in e]
    conv = sum(e.get("converged", 0) for e in solves)
    batch = sum(e.get("batch", 1) for e in solves)
    print(f"{len(solves)} SCA solves ({batch} scenarios), "
          f"{sum(durs):.3f}s total, {np.mean(durs):.4f}s mean")
    if objs:
        print(f"objective mean {np.mean(objs):.4f} "
              f"(range {min(objs):.4f} .. {max(objs):.4f}), "
              f"{conv}/{batch} converged")


def _newest_npz(run_dir: str):
    paths = sorted(glob.glob(os.path.join(run_dir, "*.npz")),
                   key=os.path.getmtime)
    return paths[-1] if paths else None


def bias_variance(npz_path: str, sample_rounds: int) -> None:
    meta = ckpt.load_meta(npz_path)
    flat = ckpt.load_flat(npz_path)
    names = meta.get("names") or []
    bv = {k[len("traces/"):]: np.asarray(v) for k, v in flat.items()
          if k.startswith("traces/bv_")}
    if not bv:
        print(f"(no bv_* traces in {npz_path} — run with "
              "telemetry diagnostics on)")
        return flat
    t_axis = next(iter(bv.values())).shape[-1]
    pts = sorted(set(np.linspace(0, t_axis - 1, sample_rounds,
                                 dtype=int).tolist()))
    print(f"from {os.path.basename(npz_path)} "
          f"({t_axis} recorded rounds; mean over seeds)")
    names = list(names or range(next(iter(bv.values())).shape[0]))

    def scheme_block(ki, label, indent="  "):
        print(f"{indent}scheme {label}")
        for key in sorted(bv):
            series = bv[key][ki].mean(axis=0)          # [T] over seeds
            vals = " ".join(f"{series[t]:11.4e}" for t in pts)
            print(f"{indent}  {key:<14} {vals}")

    # a scenario-grid run (DESIGN.md §Grid) carries the scenario axis in
    # the checkpoint identity and scenario-major "scenario/scheme" cell
    # names — segment the trajectory per scenario instead of one flat list
    scens = meta.get("scenarios")
    if isinstance(scens, (list, tuple)) and scens \
            and len(names) % len(scens) == 0:
        kb = len(names) // len(scens)
        for ci, sc_name in enumerate(scens):
            print(f"  scenario {sc_name}")
            for ki in range(ci * kb, (ci + 1) * kb):
                label = str(names[ki])
                label = label.split("/", 1)[1] if "/" in label else label
                scheme_block(ki, label, indent="    ")
    else:
        for ki, name in enumerate(names):
            scheme_block(ki, name)
    print("    rounds        "
          + " ".join(f"{t:11d}" for t in pts))
    return flat


def staleness(events, flat) -> None:
    cohort_ev = [e for e in events if e["ev"] == "cohort"
                 and e.get("staleness") is not None]
    if cohort_ev:
        stale = np.concatenate(
            [np.asarray(e["staleness"]).ravel() for e in cohort_ev])
        never = int(np.sum(stale < 0))
        seen = stale[stale >= 0]
        total = stale.size
        print(f"{len(cohort_ev)} cohorts, {total} draws "
              f"({never} first-time participants)")
        rows = [("never", never)]
        rows += [(label, int(np.sum((seen >= lo) & (seen <= hi))))
                 for lo, hi, label in _BUCKETS]
        for label, count in rows:
            frac = count / max(total, 1)
            print(f"  {label:>6} {count:6d} {_bar(frac)}")
        return
    # fallback: participation counts from the checkpoint's cohort record
    if flat is not None and "cohorts_idx" in flat:
        idx = np.asarray(flat["cohorts_idx"])          # [C, S, N]
        uniq, counts = np.unique(idx, return_counts=True)
        print(f"(no cohort events; participation from checkpoint) "
              f"{uniq.size} distinct devices over {idx.shape[0]} cohorts, "
              f"seen {counts.min()}..{counts.max()} times")
        return
    print("(no cohort events — not a population run?)")


def recompiles(events) -> None:
    # a resumed process starts with a cold jit cache, so compiles repeat
    # across run_resume boundaries by design — only a length compiled
    # twice WITHIN one process is a real recompilation
    seg, comp = 0, []
    for e in events:
        if e["ev"] == "run_resume":
            seg += 1
        elif e["ev"] == "chunk_compile":
            comp.append((seg, e))
    if not comp:
        print("(no compiles recorded)")
        return
    by_key = defaultdict(list)
    for sg, e in comp:
        by_key[(sg, e.get("length"))].append(e)
    dupes = 0
    for sg, length in sorted(by_key,
                             key=lambda x: (x[0], x[1] is None, x[1])):
        evs = by_key[(sg, length)]
        flag = "  <-- RECOMPILED" if len(evs) > 1 else ""
        dupes += len(evs) > 1
        print(f"  process {sg} length={length}: {len(evs)} compile(s), "
              + ", ".join(f"{e.get('dur', 0):.2f}s" for e in evs) + flag)
    print(f"{len(comp)} compiles over {len(by_key)} (process, length) "
          "cells" + (f"; {dupes} recompiled" if dupes
                     else " — no recompilation"))


def report(run_dir: str, npz: str = None, sample_rounds: int = 6) -> None:
    events_path = os.path.join(run_dir, EVENTS_FILE)
    if not os.path.exists(events_path):
        raise SystemExit(f"no {EVENTS_FILE} in {run_dir!r} — run with "
                         "telemetry on (e.g. repro_torch.fig2 --telemetry)")
    events = read_events(events_path)
    sections = (("run", lambda: header(events)),
                ("staging-lane timeline", lambda: timeline(events)),
                ("SCA solver", lambda: solver(events)))
    for title, fn in sections:
        print(f"== {title} " + "=" * max(1, 60 - len(title)))
        fn()
        print()
    npz = npz or _newest_npz(run_dir)
    flat = None
    print("== bias--variance trajectory " + "=" * 32)
    if npz:
        flat = bias_variance(npz, sample_rounds)
    else:
        print(f"(no fleet checkpoint .npz in {run_dir} — pass --npz)")
    print()
    print("== cohort staleness " + "=" * 41)
    staleness(events, flat)
    print()
    print("== recompilation audit " + "=" * 38)
    recompiles(events)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Render a telemetry run directory (events.jsonl + "
                    "fleet checkpoint) as a plain-text report.")
    ap.add_argument("run_dir", help="directory holding events.jsonl")
    ap.add_argument("--npz", default=None,
                    help="fleet checkpoint to read bv_* traces from "
                         "(default: newest *.npz in run_dir)")
    ap.add_argument("--rounds", type=int, default=6,
                    help="sampled rounds in the bias--variance table")
    args = ap.parse_args(argv)
    report(args.run_dir, npz=args.npz, sample_rounds=args.rounds)


if __name__ == "__main__":
    main(sys.argv[1:])
