"""The port's LM training trajectories held against the reference's.

    python -m repro_torch.lm_curves [--seeds 0 1 2 3] [--json PATH]
        [--device cuda] [--false-alarm]

Runs ``launch.train`` at the preset of the reference's example
(``examples/train_fl_transformer.py``: qwen1.5-0.5b's smoke family at
d_model 512, 8 layers, seq 128, 4 clients x 1, eta 0.05, ``sca``, 200
steps) for each seed, reads the reference's losses for the same seeds from
``experiments/lm_reference/losses_seed<s>.json`` (written on the CPU by
``python -m tests.torch_ref --lm``; the reference there starts from the
port's initial weights of the seed, handed over as an archive, so the two
sides differ only in their fading and noise draws), prints a table and
exits nonzero when the gate fails.

The gate.  Over the seeds on each side, it compares the means of three
statistics of a run:

    first10    the mean of the first 10 step losses
    last10     the mean of the last 10 step losses
    held_out   the held-out loss after the last step

and passes when |port - reference| <= max(3 * sqrt(sd_port^2 / n_port +
sd_ref^2 / n_ref), 0.02 * the reference's mean), sd the sample standard
deviation over seeds: the rule of ``curves.gate`` for a loss.  ``false_alarm`` is the rate at which the gate
misses when both sides draw from one distribution with the reference's
per-seed mean and spread (``--false-alarm``, on the CPU).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from repro_torch.curves import LOSS_FLOOR_SHARE as FLOOR_SHARE, SIGMAS

ROOT = Path(__file__).resolve().parents[2]
REFERENCE = ROOT / "experiments" / "lm_reference"
# the reference example's default preset (launch.train's keywords)
PRESET = dict(arch="qwen1.5-0.5b", smoke=True, d_model=512, n_layers=8,
              steps=200, seq=128, clients=4, per_client_batch=1, eta=0.05,
              scheme="sca", log_every=10)
SEEDS = (0, 1, 2, 3)
STATS = ("first10", "last10", "held_out")
FALSE_ALARM_MAX = 0.25


def run_stats(losses: Sequence[float], held_out: float) -> dict:
    return {"first10": float(np.mean(losses[:10])),
            "last10": float(np.mean(losses[-10:])),
            "held_out": float(held_out)}


def load_reference(seeds: Sequence[int] = SEEDS,
                   reference: Path = REFERENCE) -> list:
    """The reference's runs ({"losses", "held_out_loss", ...}) per seed."""
    out = []
    for s in seeds:
        with open(Path(reference) / f"losses_seed{s}.json") as f:
            out.append(json.load(f))
    return out


def _bound(pv, rv):
    sd_p = float(np.std(pv, ddof=1)) if len(pv) > 1 else 0.0
    sd_r = float(np.std(rv, ddof=1)) if len(rv) > 1 else 0.0
    se = np.sqrt(sd_p ** 2 / len(pv) + sd_r ** 2 / len(rv))
    return max(SIGMAS * float(se), FLOOR_SHARE * abs(float(np.mean(rv)))), \
        sd_p, sd_r


def gate(port: Sequence[dict], ref: Sequence[dict]) -> list:
    """One row per statistic: both sides' means and sample SDs over their
    seeds, the bound and whether it held.  ``port`` and ``ref`` are lists
    of runs, one per seed, each {"losses": [...], "held_out_loss": x}; a
    run of another length than the reference's fails every statistic."""
    steps = len(ref[0]["losses"])
    bad = not port or any(len(r["losses"]) != steps for r in port)
    r = [run_stats(x["losses"], x["held_out_loss"]) for x in ref]
    p = [] if bad else [run_stats(x["losses"], x["held_out_loss"])
                        for x in port]
    rows = []
    for stat in STATS:
        rv = np.asarray([x[stat] for x in r])
        if bad:
            rows.append(dict(stat=stat, port=None, ref=float(rv.mean()),
                             bound=None, sd_port=None,
                             sd_ref=float(np.std(rv, ddof=1)), ok=False,
                             note="missing or another length"))
            continue
        pv = np.asarray([x[stat] for x in p])
        bound, sd_p, sd_r = _bound(pv, rv)
        rows.append(dict(stat=stat, port=float(pv.mean()),
                         ref=float(rv.mean()), bound=bound, sd_port=sd_p,
                         sd_ref=sd_r,
                         ok=bool(abs(pv.mean() - rv.mean()) <= bound),
                         note=None))
    return rows


def false_alarm(ref: Sequence[dict], n_seeds: int, trials: int = 100_000,
                seed: int = 0) -> dict:
    """How often ``gate`` misses when the port and the reference agree in
    distribution: for each statistic both sides draw ``n_seeds`` values
    from one normal with the reference's mean and sample SD, and the
    gate's rule is applied.  Returns {"per_stat": {stat: rate}, "any":
    the share of trials with at least one miss}."""
    rng = np.random.default_rng(seed)
    stats = [run_stats(x["losses"], x["held_out_loss"]) for x in ref]
    rates, miss_any = {}, np.zeros(trials, bool)
    for stat in STATS:
        v = np.asarray([x[stat] for x in stats])
        mu, sd = v.mean(), v.std(ddof=1)
        a = rng.normal(mu, sd, (trials, n_seeds))
        b = rng.normal(mu, sd, (trials, n_seeds))
        se = np.sqrt(a.var(axis=1, ddof=1) / n_seeds
                     + b.var(axis=1, ddof=1) / n_seeds)
        miss = np.abs(a.mean(axis=1) - b.mean(axis=1)) \
            > np.maximum(SIGMAS * se, FLOOR_SHARE * np.abs(b.mean(axis=1)))
        rates[stat] = float(miss.mean())
        miss_any |= miss
    return {"per_stat": rates, "any": float(miss_any.mean())}


def table(rows: Sequence[dict]) -> str:
    lines = [f"{'stat':>9} {'port':>9} {'ref':>9} {'|diff|':>9} "
             f"{'bound':>9} {'sd_port':>9} {'sd_ref':>9} gate"]
    for r in rows:
        if r["port"] is None:
            lines.append(f"{r['stat']:>9} {r['note']} FAIL")
            continue
        lines.append(f"{r['stat']:>9} {r['port']:9.4f} {r['ref']:9.4f} "
                     f"{abs(r['port'] - r['ref']):9.4f} {r['bound']:9.4f} "
                     f"{r['sd_port']:9.4f} {r['sd_ref']:9.4f} "
                     f"{'ok' if r['ok'] else 'FAIL'}")
    return "\n".join(lines)


def _run_seed(seed: int, device=None, design=None) -> dict:
    from repro_torch.launch import train
    res = train.run(**PRESET, seed=seed, device=device, design=design)
    return {"losses": res.losses, "held_out_loss": res.held_out,
            "stats": res.stats}


def design(seed: int, device=None):
    """The preset run's design at ``seed`` (``launch.train.design_of``),
    solved on ``device``: it needs no weights, so it can be made ahead."""
    from repro_torch.launch import train
    return train.design_of(dict(PRESET, seed=seed), device)


def run_port(seeds: Sequence[int] = SEEDS, device=None, jobs: int = 1,
             designs: Optional[Sequence] = None) -> list:
    """``launch.train.run`` at the preset for each seed: {"losses",
    "held_out_loss", "stats"} per seed.  ``jobs`` > 1 runs that many seeds
    at once, each in a spawned process of its own on the same device: a
    run's numbers depend only on its seed, and most of its wall is the
    host's (the ``sca`` design), so the runs overlap; each run's step
    times are then taken beside the others'.  ``designs`` (one per seed,
    ``design``) are the runs' designs made beforehand."""
    designs = list(designs) if designs is not None else [None] * len(seeds)
    if jobs <= 1:
        return [_run_seed(s, device, d) for s, d in zip(seeds, designs)]
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    with ProcessPoolExecutor(jobs, mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        return list(pool.map(_run_seed, seeds, [device] * len(seeds),
                             designs))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=list(SEEDS))
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default=None)
    ap.add_argument("--false-alarm", action="store_true",
                    help="print the gate's false-alarm rate at the seeds' "
                         "count from the reference's runs, and exit")
    a = ap.parse_args(argv)
    ref = load_reference(a.seeds)
    if a.false_alarm:
        print(json.dumps(false_alarm(ref, len(a.seeds))))
        return 0
    port = run_port(a.seeds, a.device)
    rows = gate(port, ref)
    print(table(rows), flush=True)
    if a.json:
        Path(a.json).parent.mkdir(parents=True, exist_ok=True)
        with open(a.json, "w") as f:
            json.dump({"rows": rows, "port": port}, f)
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
