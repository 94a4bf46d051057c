"""The port's Fig.-2 curves held against the reference's.

    python -m repro_torch.curves [--seeds 0 1 2 3] [--json PATH]
        [--device cuda]

Runs ``repro_torch.fig2.run`` for every seed in each protocol (the paper's
full batch, aggregated leaf by leaf; minibatch 128 on the fused f32 path,
through kernel K1) at the reference's cadence (150 rounds, an eval every
10 and at the last round), reads the reference's curves for the same seeds
(``experiments/fig2_reference/<protocol>/histories_seed<s>.json``, written
on the CPU by ``python -m tests.torch_ref``), prints a per-scheme table and
exits nonzero when the gate fails.

The gate.  The port draws its random numbers from torch generators, not
JAX's threefry, so the port at seed s is not the reference at seed s: the
check is statistical.  For each scheme and protocol, over the seeds on each
side, it compares the means of three statistics of a curve:

    final_acc    test accuracy at the last eval point
    final_loss   global loss at the last eval point
    mean_acc     test accuracy averaged over every eval point

and passes when |port - reference| <= max(3 * sqrt(sd_port^2 / n_port +
sd_ref^2 / n_ref), floor), sd the sample standard deviation over seeds;
the floor is 0.01 for the accuracies and 0.02 * the reference's mean for
the loss.  A scheme whose eval rounds differ from the reference's (another
cadence or length) fails every statistic.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np

PROTOCOLS = {"full_batch": 0, "minibatch128": 128}
ROUNDS, EVERY = 150, 10     # the reference's Fig.-2 cadence
STATS = ("final_acc", "final_loss", "mean_acc")
ACC_FLOOR = 0.01
LOSS_FLOOR_SHARE = 0.02
SIGMAS = 3.0
ROOT = Path(__file__).resolve().parents[2]
REFERENCE = ROOT / "experiments" / "fig2_reference"


def curve_stats(rows: Sequence[dict]) -> dict:
    """The gate's statistics of one scheme's eval rows (one seed)."""
    return {"final_acc": float(rows[-1]["acc"]),
            "final_loss": float(rows[-1]["global_loss"]),
            "mean_acc": float(np.mean([r["acc"] for r in rows]))}


def load_reference(protocol: str, seeds: Sequence[int]) -> list:
    """The reference's histories ({scheme: [eval rows]}) per seed."""
    out = []
    for s in seeds:
        with open(REFERENCE / protocol / f"histories_seed{s}.json") as f:
            out.append(json.load(f))
    return out


def _rounds(rows: Sequence[dict]) -> list:
    return [int(r["round"]) for r in rows]


def gate(port: Sequence[dict], ref: Sequence[dict]) -> list:
    """One row per (scheme, statistic): both sides' means and sample SDs
    over their seeds, the bound and whether it held.  ``port`` and ``ref``
    are lists of histories, one per seed; the schemes are the reference's.
    A scheme missing from a port history, or whose eval rounds differ from
    the reference's, fails (``note`` says which)."""
    rows = []
    for scheme in ref[0]:
        rounds = _rounds(ref[0][scheme])
        if any(_rounds(h[scheme]) != rounds for h in ref):
            raise ValueError(f"reference {scheme}: eval rounds differ "
                             "between seeds")
        r = [curve_stats(h[scheme]) for h in ref]
        note = "missing" if not port or any(scheme not in h for h in port) \
            else "rounds" if any(_rounds(h[scheme]) != rounds
                                 for h in port) else None
        p = [] if note else [curve_stats(h[scheme]) for h in port]
        for stat in STATS:
            rv = np.asarray([x[stat] for x in r])
            pv = np.asarray([x[stat] for x in p])
            ref_mean = float(rv.mean())
            floor = LOSS_FLOOR_SHARE * abs(ref_mean) if stat == "final_loss" \
                else ACC_FLOOR
            sd_r = float(rv.std(ddof=1)) if len(rv) > 1 else 0.0
            if note:
                rows.append(dict(scheme=scheme, stat=stat, port=None,
                                 ref=ref_mean, sd_port=None, sd_ref=sd_r,
                                 bound=floor, ok=False, note=note))
                continue
            sd_p = float(pv.std(ddof=1)) if len(pv) > 1 else 0.0
            bound = max(SIGMAS * float(np.sqrt(sd_p**2 / len(pv)
                                               + sd_r**2 / len(rv))), floor)
            port_mean = float(pv.mean())
            rows.append(dict(scheme=scheme, stat=stat, port=port_mean,
                             ref=ref_mean, sd_port=sd_p, sd_ref=sd_r,
                             bound=bound,
                             ok=bool(abs(port_mean - ref_mean) <= bound),
                             note=None))
    return rows


def table(rows: Sequence[dict], title: str = "") -> str:
    lines = [title] if title else []
    lines.append(f"{'scheme':>17} {'stat':>10} {'port':>9} {'ref':>9} "
                 f"{'|diff|':>9} {'bound':>9} {'sd_port':>9} {'sd_ref':>9} "
                 "gate")
    for r in rows:
        if r["port"] is None:
            lines.append(f"{r['scheme']:>17} {r['stat']:>10} {r['note']:>9} "
                         f"{r['ref']:9.4f} {'':>9} {r['bound']:9.4f} "
                         f"{'':>9} {r['sd_ref']:9.4f} FAIL")
            continue
        lines.append(
            f"{r['scheme']:>17} {r['stat']:>10} {r['port']:9.4f} "
            f"{r['ref']:9.4f} {abs(r['port'] - r['ref']):9.4f} "
            f"{r['bound']:9.4f} {r['sd_port']:9.4f} {r['sd_ref']:9.4f} "
            f"{'ok' if r['ok'] else 'FAIL'}")
    return "\n".join(lines)


def run_port(protocol: str, seeds: Sequence[int], device=None, designs=None,
             after_run: Optional[Callable] = None) -> list:
    """``fig2.run`` for each seed of one protocol at the reference's
    cadence (nothing saved); returns the histories.  The schemes are designed once (``designs``, default
    ``fig2.make_schemes``): the world does not depend on the data seed.
    ``after_run(seed, res)`` is called after each run, e.g. to read the
    kernels' launch counts."""
    from repro_torch import fig2
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    if designs is None:
        designs = design_schemes(dev)
    out = []
    for s in seeds:
        hist, res = fig2.run(num_rounds=ROUNDS, eval_every=EVERY, seed=s,
                             batch_size=PROTOCOLS[protocol],
                             uplink_dtype="f32", save=False, designs=designs,
                             device=dev)
        if after_run is not None:
            after_run(s, res)
        out.append(hist)
    return out


def design_schemes(device):
    """The seven Fig.-2 schemes at paper_mlp's world (data seed 0; the
    world does not depend on it)."""
    from repro_torch import fig2, tasks
    task = tasks.get("paper_mlp", expect_runtime="fleet")
    dep, prm, _ = fig2.build_world(task, 0)
    return fig2.make_schemes(task, dep, prm, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--json", default=None,
                    help="also write the gate's rows here")
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    from repro_torch.device import resolve_device
    dev = resolve_device(a.device)
    designs = design_schemes(dev)
    ok, report = True, {}
    for protocol in PROTOCOLS:
        port = run_port(protocol, a.seeds, dev, designs)
        rows = gate(port, load_reference(protocol, a.seeds))
        print(table(rows, f"{protocol}: port vs reference, seeds "
                          f"{a.seeds}, {ROUNDS} rounds"), flush=True)
        report[protocol] = rows
        ok &= all(r["ok"] for r in rows)
    if a.json:
        Path(a.json).parent.mkdir(parents=True, exist_ok=True)
        with open(a.json, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"curves_gate": "pass" if ok else "fail"}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
