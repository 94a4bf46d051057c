"""Scenario-family sweep on the port: the Theorem-1 rows per scenario x
scheme, a fleet per scenario, and the [scenario x scheme x seed] grid
fleet, ported from ``benchmarks/scenario_sweep.py``.

    python -m repro_torch.scenario_sweep [--all] [--train] [--grid]
        [--false-alarm] [--rss-probe] [--json PATH]
        [--device cuda]

For every scenario (``scenarios.SWEEP_FAMILIES``; ``--all`` the whole
registry) and every statistical-CSI scheme (sca, lcpc, zero_bias) it
prints the Theorem-1 decomposition with the scenario's family-aware
statistics:

    bias        2 N kappa^2 sum_m (p_m - 1/N)^2          (theory.bias_term)
    variance    zeta = transmission + minibatch + noise  (theory.zeta_terms)
    objective   2 eta L zeta + bias                      (the (P1) objective)

The ``sca`` designs of the scenarios are solved in one batched solve per
fading family (``power_control.make_sca_batch``).  ``--train`` runs a
registered task (paper_mlp, its own batch: full batch) on each scenario's
fading process, the scheme axis as one fleet.  ``--grid`` runs ``grid``,
the check that ``chip_smoke.py`` phase 8 runs too: the 48-cell grid of the
``SWEEP_FAMILIES`` x schemes x seeds 0-3 as ONE fleet through
``run_fleet(scenarios=...)`` (flat, fused f32 tail: kernel K1 once a round
over the 48 cells), the same grid at seeds 4-7, the grid's bitwise
identities, and ``curves.gate`` against the reference's committed grid
(``experiments/scenario_reference``) over seeds 0-7; it exits nonzero on a
miss.  ``--false-alarm`` prints how often that gate misses when the port
and the reference agree in distribution, at four and at eight seeds a
side (``gate_false_alarm``, on the CPU).  ``--rss-probe`` runs the
48-cell grid for ``RSS_PROBE_ROUNDS`` (20) rounds in a fresh child process
and prints its peak host RSS and peak device memory (``rss_probe``: the
reference's probe compares buffer donation on and off; the port has no
donation -- a round's old tensors are freed when their references drop --
so it reports the one run).  The settings are the
reference's: eta 0.05 for every scheme, kappa^2 4, 100 rounds, an eval
every 20, deployment seed 0.  JSON (the rows, the grid's identities, gate
and histories) is written only where ``--json`` points.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import power_control as pcm
from repro_torch.core import scenarios as scn
from repro_torch.core import theory

SCHEMES = ("sca", "lcpc", "zero_bias")
D, GMAX, ETA, KAPPA_SQ = 814090, 10.0, 0.05, 4.0
ROUNDS, EVERY, SEEDS = 100, 20, (0, 1, 2, 3)
# The curve gate's seeds: the grid at SEEDS, then at the others.  With
# four seeds a side each sample SD rests on three degrees of freedom and
# the 3-SE bound misses often where the two sides agree in distribution
# (``gate_false_alarm``; PERF.md has its rates at four and eight seeds).
GATE_SEEDS = tuple(range(8))
IDENTITY_ROUNDS, UNFUSED_ROUNDS = 10, 5
ROOT = Path(__file__).resolve().parents[2]
REFERENCE = ROOT / "experiments" / "scenario_reference"


def scheme_theory_row(pc, prm) -> dict:
    """Theorem-1 decomposition of a designed truncated-inversion scheme."""
    z = theory.zeta_terms(pc.gamma, prm)
    bias = theory.bias_term(pc.p, prm)
    return {
        "scheme": pc.name,
        "bias": bias,
        "variance": z["total"],
        "var_transmission": z["transmission"],
        "var_noise": z["noise"],
        "objective": 2.0 * prm.eta * prm.lsmooth * z["total"] + bias,
        "p_spread": float(np.max(pc.p) - np.min(pc.p)),
        "mean_participation": float(np.mean(
            theory.expected_participation_indicator(pc.gamma, prm))),
    }


def _family(prm) -> str:
    return "rayleigh" if prm.is_rayleigh else prm.fading.family


def design(scenario_names=scn.SWEEP_FAMILIES, schemes=SCHEMES, d: int = D,
           gmax: float = GMAX, eta: float = ETA, kappa_sq: float = KAPPA_SQ,
           device=None, jobs: int = 1) -> dict:
    """Every scenario's world and its schemes: {"order": names,
    name: {"scenario", "dep", "prm", "schemes"}, "sca_calls": [(family,
    scenario names, seconds)]}.  ``sca`` takes one batched solve per
    fading family, on ``device``; the other schemes are host designs.  The
    deployments are realized at seed 0.  ``jobs`` > 1 runs that many
    families' solves at once, each in a spawned process of its own on
    ``device`` (a solve is mostly host work: small launches)."""
    world = {"order": tuple(scenario_names), "sca_calls": []}
    for name in scenario_names:
        sc = scn.get_scenario(name)
        dep = scn.realize(sc, seed=0)
        prm = scn.make_ota_params(dep, d=d, gmax=gmax, eta=eta,
                                  kappa_sq=kappa_sq)
        world[name] = {"scenario": sc, "dep": dep, "prm": prm,
                       "schemes": {s: pcm.make_power_control(s, dep, prm)
                                   for s in schemes if s != "sca"}}
    if "sca" in schemes:
        groups = {}
        for n in scenario_names:
            groups.setdefault(_family(world[n]["prm"]), []).append(n)
        calls = [[world[n]["prm"] for n in g] for g in groups.values()]
        if jobs > 1:
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor
            with ProcessPoolExecutor(jobs, mp_context=multiprocessing
                                     .get_context("spawn")) as pool:
                solved = list(pool.map(_sca_batch, calls,
                                       [device] * len(calls)))
        else:
            solved = [_sca_batch(c, device) for c in calls]
        for (fam, group), (pcs, sec) in zip(groups.items(), solved):
            world["sca_calls"].append((fam, tuple(group), sec))
            for n, pc in zip(group, pcs):
                world[n]["schemes"]["sca"] = pc
    for name in scenario_names:
        world[name]["schemes"] = [world[name]["schemes"][s] for s in schemes]
    return world


def _sca_batch(prms, device) -> tuple:
    """``make_sca_batch`` of one family's worlds and its seconds."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    t0 = time.time()
    pcs = pcm.make_sca_batch(prms, device=device)
    return pcs, time.time() - t0


def sweep(world: dict) -> list:
    """One theory row per (scenario, scheme) of a ``design``ed world."""
    rows = []
    for name in world["order"]:
        w = world[name]
        for pc in w["schemes"]:
            row = scheme_theory_row(pc, w["prm"])
            row.update(scenario=name, fading=w["dep"].fading_spec.family,
                       gain_spread_db=float(10 * np.log10(
                           w["dep"].gains.max() / w["dep"].gains.min())))
            rows.append(row)
    return rows


def _task(task):
    from repro_torch import tasks
    return tasks.get(task, expect_runtime="fleet") \
        if isinstance(task, str) else task


def run_config(task, num_rounds, eval_every):
    """The sweep's run config: eta 0.05, seed 0 and the task's own batch
    (paper_mlp: full batch)."""
    return task.run_config(eta=ETA, num_rounds=num_rounds,
                           eval_every=eval_every, seed=0,
                           batch_size=int(task.defaults.get("batch_size", 0)))


def scenario_fleet(task, world: dict, name: str, run, seeds, **kw):
    """The fleet of one scenario: its schemes on its fading process."""
    from repro_torch.fl.driver import run_fleet_task
    w = world[name]
    fading = scn.make_fading_process(w["dep"], w["scenario"].dynamics)
    return run_fleet_task(task, w["schemes"], w["dep"].gains, run,
                          etas=[run.eta] * len(w["schemes"]), seeds=seeds,
                          fading=fading, flat=True, **kw)


def grid_world(world: dict, names):
    """(the ``ScenarioStack`` of ``names``, their schemes scenario-major)."""
    stack = scn.stack_deployments([world[n]["dep"] for n in names],
                                  [world[n]["scenario"].dynamics
                                   for n in names], names=names)
    return stack, [pc for n in names for pc in world[n]["schemes"]]


def grid_fleet(task, world: dict, names, run, seeds, **kw):
    """ONE [R x K x S] fleet over the stacked scenarios: the schemes
    scenario-major, the channel from the ``ScenarioStack``."""
    from repro_torch.fl.driver import run_fleet_task
    stack, pcs = grid_world(world, names)
    return run_fleet_task(task, pcs, None, run, etas=[run.eta] * len(pcs),
                          seeds=seeds, flat=True, scenarios=stack, **kw)


def bitwise(a, b, cells: slice = slice(None)) -> bool:
    """Params and traces of ``a``'s cells ``cells`` equal ``b``'s, bit
    for bit (the reference's ``_results_bitwise``, on a slice of a's
    scheme axis)."""
    ok = set(a.params) == set(b.params) and all(
        torch.equal(a.params[k][cells], b.params[k]) for k in a.params)
    return bool(ok and set(a.traces) == set(b.traces) and all(
        np.array_equal(a.traces[k][cells], b.traces[k]) for k in a.traces))


def histories(res) -> list:
    """A fleet's evals as one history per seed, {cell name: [{"round",
    "acc", "global_loss"}]}: the form ``curves.gate`` reads."""
    return [{name: [{"round": int(t), "acc": float(ev["acc"][i, si]),
                     "global_loss": float(ev["global_loss"][i, si])}
                    for t, ev in res.evals]
             for i, name in enumerate(res.names)}
            for si in range(len(res.seeds))]


def load_reference(seeds: Sequence[int]) -> list:
    out = []
    for s in seeds:
        with open(REFERENCE / "grid" / f"histories_seed{s}.json") as f:
            out.append(json.load(f))
    return out


def load_theory_reference(seed: int = 0) -> dict:
    with open(REFERENCE / f"theory_seed{seed}.json") as f:
        return json.load(f)


def theory_errors(rows: Sequence[dict], ref: dict) -> dict:
    """Largest relative error of bias, variance and objective per
    (scenario, scheme) against the reference's rows."""
    want = {(r["scenario"], r["scheme"]): r for r in ref["rows"]}
    out = {}
    for r in rows:
        w = want[(r["scenario"], r["scheme"])]
        out[f"{r['scenario']}/{r['scheme']}"] = max(
            abs(r[k] - w[k]) / abs(w[k])
            for k in ("bias", "variance", "objective"))
    return out


def train_sweep(world: dict, task="paper_mlp", device=None) -> list:
    """A fleet per scenario of ``world`` (its schemes on its fading
    process; ROUNDS rounds, seed 0), the task built once; one row per
    (scenario, scheme)."""
    from repro_torch.device import resolve_device
    task = _task(task)
    td = task.build_data(0)
    dev = resolve_device(device)
    kw = dict(task_data=td, params=task.init_params(0, dev),
              eval_fn=task.make_eval(td, dev), device=dev)
    run = run_config(task, ROUNDS, EVERY)
    rows = []
    for name in world["order"]:
        res = scenario_fleet(task, world, name, run, (0,), **kw)
        final = res.evals[-1][1]["acc"]
        for i, scheme in enumerate(res.names):
            rows.append({"scenario": name, "scheme": scheme,
                         "final_acc": round(float(final[i, 0]), 4),
                         "rounds": ROUNDS})
    return rows


def _ota_counters() -> dict:
    from repro_torch.kernels import ota_aggregate, ref, round_step
    return {"ota_round_step": (round_step.ota_round_step, "launches"),
            "ota_aggregate": (ota_aggregate.ota_aggregate, "launches"),
            "plain_round_step": (ref.ota_round_step_ref, "calls"),
            "plain_aggregate": (ref.ota_aggregate_ref, "calls")}


def _counted(fleet, dev):
    """``fleet()`` with the round tail's counters (K1 and K2 launches, their
    plain versions' calls) set to 0 just before it and read just after:
    (result, counts, seconds)."""
    ctr = _ota_counters()
    for fn, attr in ctr.values():
        setattr(fn, attr, 0)
    t0 = time.time()
    res = fleet()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return (res, {k: getattr(fn, attr) for k, (fn, attr) in ctr.items()},
            time.time() - t0)


def grid(world: dict, task="paper_mlp", device=None) -> dict:
    """The grid check, on ``world``'s designs of the ``SWEEP_FAMILIES``:

    1. the [4 x 3 x 4] grid at SEEDS, ROUNDS rounds with an eval every
       EVERY (full batch, flat, fused f32 tail: K1 once a round over 48
       cells), with the round tail's counts of that run;
    2. the same grid at the gate's other seeds (GATE_SEEDS minus SEEDS);
    3. its identities at SEEDS, each pair bitwise: IDENTITY_ROUNDS rounds
       of the R = 1 grid vs the disk_rayleigh fleet, of the grid vs each
       scenario's own fleet, and of the grid with K1 forced off vs on;
       UNFUSED_ROUNDS unfused rounds with K2 forced off vs on (with K2's
       counts);
    4. ``curves.gate`` of 1 and 2 against the reference's grid over
       GATE_SEEDS.

    Returns {"result", "more": the FLResults of 1 and 2, "counts": {"grid",
    "unfused"}, "identities": {name: bool, "grid_vs_scenario_fleets":
    [bool per scenario]}, "gate": rows, "walls": seconds}."""
    from repro_torch import curves
    from repro_torch.device import resolve_device
    task = _task(task)
    dev = resolve_device(device)
    td = task.build_data(0)
    kw = dict(task_data=td, params=task.init_params(0, dev),
              eval_fn=task.make_eval(td, dev), device=dev)
    names = scn.SWEEP_FAMILIES
    run = run_config(task, ROUNDS, EVERY)
    res, grid_counts, grid_s = _counted(
        lambda: grid_fleet(task, world, names, run, SEEDS, **kw), dev)
    more_seeds = tuple(s for s in GATE_SEEDS if s not in SEEDS)
    more, _, more_s = _counted(
        lambda: grid_fleet(task, world, names, run, more_seeds, **kw), dev)
    gate = curves.gate(histories(res) + histories(more),
                       load_reference(SEEDS + more_seeds))

    t0 = time.time()
    short = run_config(task, IDENTITY_ROUNDS, IDENTITY_ROUNDS)
    g = grid_fleet(task, world, names, short, SEEDS, **kw)
    k = len(world[names[0]]["schemes"])
    per = [scenario_fleet(task, world, n, short, SEEDS, **kw) for n in names]
    one = grid_fleet(task, world, names[:1], short, SEEDS, **kw)
    off = grid_fleet(task, world, names, short, SEEDS, use_kernel=False,
                     **kw)
    unf = run_config(task, UNFUSED_ROUNDS, UNFUSED_ROUNDS)
    k2, unfused_counts, _ = _counted(
        lambda: grid_fleet(task, world, names, unf, SEEDS, fuse_round=False,
                           **kw), dev)
    k2_off = grid_fleet(task, world, names, unf, SEEDS, fuse_round=False,
                        use_kernel=False, **kw)
    ids = {"r1_grid_vs_fleet": bitwise(one, per[0]),
           "grid_vs_scenario_fleets": [
               bitwise(g, f, slice(r * k, (r + 1) * k))
               for r, f in enumerate(per)],
           "k1_off_vs_on": bitwise(off, g),
           "k2_off_vs_on": bitwise(k2_off, k2)}
    return {"result": res, "more": more,
            "counts": {"grid": grid_counts, "unfused": unfused_counts},
            "identities": ids, "gate": gate,
            "walls": {"grid_s": grid_s, "grid_more_seeds_s": more_s,
                      "identities_s": time.time() - t0}}


def grid_ok(rep: dict) -> dict:
    """Which of ``grid``'s checks held: K1 once a round and nothing else of
    the tail in the grid run, K2 once a round in the unfused one, every
    identity, every gate row."""
    ids = rep["identities"]
    return {
        "grid_launches": rep["counts"]["grid"] == {
            "ota_round_step": ROUNDS, "ota_aggregate": 0,
            "plain_round_step": 0, "plain_aggregate": 0},
        "unfused_launches": rep["counts"]["unfused"] == {
            "ota_round_step": 0, "ota_aggregate": UNFUSED_ROUNDS,
            "plain_round_step": 0, "plain_aggregate": 0},
        "identities": all(all(v) if isinstance(v, list) else v
                          for v in ids.values()),
        "gate": all(r["ok"] for r in rep["gate"])}


def gate_false_alarm(ref: Sequence[dict], n_seeds: int,
                     trials: int = 100_000, seed: int = 0) -> dict:
    """How often ``curves.gate`` misses when the port and the reference
    agree in distribution.  For each (cell, statistic) of the reference's
    histories ``ref`` (one per seed), both sides draw ``n_seeds`` values
    from one normal with the reference's mean and sample SD, and the gate's
    rule is applied: |difference of the means| > max(SIGMAS standard errors
    from both sides' sample SDs, the floor).  Each comparison draws
    independently.  Returns {"per_comparison": {"cell/stat": rate},
    "any": the share of trials with at least one miss}."""
    from repro_torch import curves
    rng = np.random.default_rng(seed)
    stats = {cell: [curves.curve_stats(h[cell]) for h in ref]
             for cell in ref[0]}
    rates, miss_any = {}, np.zeros(trials, bool)
    for cell, per_seed in stats.items():
        for stat in curves.STATS:
            v = np.asarray([x[stat] for x in per_seed])
            mu, sd = v.mean(), v.std(ddof=1)
            a = rng.normal(mu, sd, (trials, n_seeds))
            b = rng.normal(mu, sd, (trials, n_seeds))
            se = np.sqrt(a.var(axis=1, ddof=1) / n_seeds
                         + b.var(axis=1, ddof=1) / n_seeds)
            floor = curves.LOSS_FLOOR_SHARE * np.abs(b.mean(axis=1)) \
                if stat == "final_loss" else curves.ACC_FLOOR
            miss = np.abs(a.mean(axis=1) - b.mean(axis=1)) \
                > np.maximum(curves.SIGMAS * se, floor)
            rates[f"{cell}/{stat}"] = float(miss.mean())
            miss_any |= miss
    return {"per_comparison": rates, "any": float(miss_any.mean())}


RSS_PROBE_ROUNDS = 20


def _rss_probe_child(device) -> None:
    """Child side of ``rss_probe``: design the grid's world, run it at
    seeds 0-3 for ``RSS_PROBE_ROUNDS`` rounds, print the high-water
    marks."""
    import resource
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    task = _task("paper_mlp")
    world = design(scn.SWEEP_FAMILIES, device=dev)
    td = task.build_data(0)
    t0 = time.time()
    grid_fleet(task, world, scn.SWEEP_FAMILIES,
               run_config(task, RSS_PROBE_ROUNDS, RSS_PROBE_ROUNDS), SEEDS,
               task_data=td, params=task.init_params(0, dev),
               eval_fn=task.make_eval(td, dev), device=dev)
    out = {"rounds": RSS_PROBE_ROUNDS, "grid_s": time.time() - t0,
           "peak_rss_mb":
               resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        out["peak_device_mb"] = torch.cuda.max_memory_allocated(dev) / 2**20
        out["device_total_mb"] = \
            torch.cuda.get_device_properties(dev).total_memory / 2**20
    print("RSS_PROBE " + json.dumps(out), flush=True)


def rss_probe(device=None) -> dict:
    """Peak host RSS and peak device memory of the 48-cell grid, from a
    fresh process (a high-water mark means something only process-wide)."""
    import os
    import subprocess
    cmd = [sys.executable, "-m", "repro_torch.scenario_sweep",
           "--rss-probe-child"]
    if device is not None:
        cmd += ["--device", str(device)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=str(ROOT))
    line = next((ln for ln in proc.stdout.splitlines()
                 if ln.startswith("RSS_PROBE ")), None)
    if proc.returncode != 0 or line is None:
        raise RuntimeError(f"rss probe failed:\n{proc.stderr[-3000:]}")
    return json.loads(line[len("RSS_PROBE "):])


def _fmt(v):
    return f"{v:.4g}" if isinstance(v, float) else str(v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--all", action="store_true",
                    help="sweep every registered scenario")
    ap.add_argument("--train", action="store_true",
                    help="also run a fleet per scenario")
    ap.add_argument("--grid", action="store_true",
                    help="run the grid check (the grid fleet, its "
                         "identities and the gate)")
    ap.add_argument("--false-alarm", action="store_true",
                    help="print the grid gate's false-alarm rates and exit")
    ap.add_argument("--rss-probe", action="store_true",
                    help="peak host RSS and device memory of the grid "
                         "(a child process) and exit")
    ap.add_argument("--rss-probe-child", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--json", default=None, help="write the results here")
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    if a.rss_probe_child:
        _rss_probe_child(a.device)
        return 0
    if a.rss_probe:
        out = rss_probe(a.device)
        print(json.dumps(out), flush=True)
        if a.json:
            Path(a.json).parent.mkdir(parents=True, exist_ok=True)
            with open(a.json, "w") as f:
                json.dump({"rss_probe": out}, f, indent=1)
        return 0
    if a.false_alarm:
        ref = load_reference(GATE_SEEDS)
        for n in (len(SEEDS), len(GATE_SEEDS)):
            fa = gate_false_alarm(ref, n)
            worst = sorted(fa["per_comparison"].items(), key=lambda kv: -kv[1])
            print(f"# {n} seeds a side: P(some miss of "
                  f"{len(fa['per_comparison'])}) = {fa['any']:.4f}; "
                  f"largest per comparison: " + ", ".join(
                      f"{c} {r:.4f}" for c, r in worst[:4]), flush=True)
        return 0
    names = scn.scenario_names() if a.all else scn.SWEEP_FAMILIES
    from repro_torch.device import resolve_device
    dev = resolve_device(a.device)

    world = design(names, device=dev)
    for fam, group, sec in world["sca_calls"]:
        print(f"# sca designs ({fam}: {', '.join(group)}): one batched "
              f"solve, {sec:.3f} s", flush=True)
    rows = sweep(world)
    cols = ("scenario", "scheme", "bias", "variance", "objective",
            "p_spread", "mean_participation", "gain_spread_db")
    print(",".join(cols))
    for r in rows:
        print(",".join(_fmt(r[c]) for c in cols), flush=True)
    out, ok = {"theory": rows}, True
    if a.train:
        out["train"] = train_sweep(world, device=dev)
        print("scenario,scheme,final_acc,rounds")
        for r in out["train"]:
            print(f"{r['scenario']},{r['scheme']},{r['final_acc']},"
                  f"{r['rounds']}", flush=True)
    if a.grid:
        from repro_torch import curves
        rep = grid(world, device=dev)
        checks = grid_ok(rep)
        print(f"# grid [{len(scn.SWEEP_FAMILIES)} x {len(SCHEMES)} x "
              f"{len(SEEDS)}], seeds {list(SEEDS)} then "
              f"{[s for s in GATE_SEEDS if s not in SEEDS]}: walls "
              f"{json.dumps(rep['walls'])}; counts "
              f"{json.dumps(rep['counts'])}; identities "
              f"{json.dumps(rep['identities'])}; checks {json.dumps(checks)}",
              flush=True)
        print(curves.table(rep["gate"], "grid: port vs reference"),
              flush=True)
        ok &= all(checks.values())
        out["grid"] = {
            "identities": rep["identities"], "counts": rep["counts"],
            "checks": checks, "walls": rep["walls"], "gate": rep["gate"],
            "chunk_walls": [r.chunk_walls for r in (rep["result"],
                                                    rep["more"])],
            "histories": dict(zip(
                rep["result"].seeds + rep["more"].seeds,
                histories(rep["result"]) + histories(rep["more"])))}
    if a.json:
        Path(a.json).parent.mkdir(parents=True, exist_ok=True)
        with open(a.json, "w") as f:
            json.dump(out, f, indent=1, default=float)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
