"""SCA power-control benchmarks on the port: solution quality, the
bias-variance trade-off, the Theorem-1 bound, and the solvers' walls
(ported from ``benchmarks/sca_bench.py``).

    python -m repro_torch.sca_bench [--json PATH] [--device cuda]

At the reference's settings: device counts ``SIZES``, batches ``BATCHES``,
``NUM_SEEDS`` seeds for the oracle rows.

* ``run``: the host SLSQP SCA (``core.sca.solve_sca``) against the
  multi-start L-BFGS-B oracle (``core.sca.solve_direct``), per device
  count: the objective gap, iterations, the ratio to the zero-bias design;
* ``solver_benchmark``: the SLSQP loop against the port's batched f64
  torch solver (``solvers.solve_batch``) on the card and on the host CPU,
  per device count and batch size: walls, speedups, the objective gap;
* ``tradeoff_sweep``: the bias-variance decomposition along gamma =
  f gamma_max (noise falls and bias rises as f grows);
* ``bound_decomposition``: the Theorem-1 bound's three terms for the SCA
  and zero-bias designs over T rounds.

The JSON goes to ``--json`` only (nothing when it is not given).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from repro_torch.core import channel, sca, theory
from repro_torch.core.theory import OTAParams
from repro_torch.device import resolve_device


def make_prm(n: int, seed: int, d: int = 814090) -> OTAParams:
    wcfg = channel.WirelessConfig(num_devices=n, seed=seed)
    dep = channel.deploy(wcfg)
    return OTAParams(d=d, gmax=10.0, es=wcfg.energy_per_sample,
                     n0=wcfg.noise_psd, gains=dep.gains,
                     sigma_sq=np.zeros(n), eta=0.05, lsmooth=1.0,
                     kappa_sq=4.0)


SIZES = (10, 20, 50)
BATCHES = (1, 16, 64)
NUM_SEEDS = 5


def run(num_seeds: int = NUM_SEEDS, sizes=SIZES) -> list:
    """SLSQP SCA against the ``solve_direct`` oracle (host numpy)."""
    rows = []
    for n in sizes:
        gaps, iters, times, vs_zb = [], [], [], []
        for seed in range(num_seeds):
            prm = make_prm(n, seed)
            t0 = time.time()
            res = sca.solve_sca(prm)
            dt = time.time() - t0
            oracle = sca.solve_direct(prm, num_starts=6, seed=seed)
            zb = theory.p1_objective(theory.zero_bias_gamma(prm), prm)
            gaps.append(res.objective / max(oracle.objective, 1e-30) - 1.0)
            vs_zb.append(res.objective / zb)
            iters.append(res.iterations)
            times.append(dt)
        rows.append({
            "bench": f"sca_n{n}",
            "us_per_call": float(np.mean(times) * 1e6),
            "iters_mean": float(np.mean(iters)),
            "gap_vs_oracle_max": float(np.max(gaps)),
            "objective_vs_zero_bias": float(np.mean(vs_zb)),
        })
    return rows


def _timed(fn, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.time()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.time() - t0


def solver_benchmark(sizes=SIZES, batches=BATCHES, device=None) -> dict:
    """The SLSQP loop against the batched torch solver, on ``device``
    (default: the card) and on the host CPU.

    Per device count: the objective gap on the reference scenario (seed
    0), then per batch size the walls of the SLSQP loop, of a first and a
    second batched solve on the device (the first pays the device's
    warm-up; the reference separates its compile the same way) and of one
    on the host CPU, with the speedups and the largest objective gap."""
    from repro_torch import solvers
    dev = resolve_device(device)
    cpu = torch.device("cpu")
    out = {"device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu"),
           "sizes": [],
           "config": {k: (list(v) if isinstance(v, tuple) else v)
                      for k, v in dataclasses.asdict(
                          solvers.DEFAULT_CONFIG).items()}}
    for n in sizes:
        prms = [make_prm(n, seed) for seed in range(max(batches))]
        ref = sca.solve_sca(prms[0])
        res = solvers.solve(prms[0], device=dev)
        row = {"num_devices": n, "scipy_objective": ref.objective,
               "torch_objective": res.objective,
               "objective_rel_gap": res.objective / ref.objective - 1.0,
               "batch": []}
        for b in batches:
            sub = prms[:b]
            t0 = time.time()
            scipy_objs = [sca.solve_sca(p).objective for p in sub]
            t_scipy = time.time() - t0
            _, t_first = _timed(lambda: solvers.solve_batch(sub, device=dev),
                                dev)
            br, t_dev = _timed(lambda: solvers.solve_batch(sub, device=dev),
                               dev)
            _, t_cpu = _timed(lambda: solvers.solve_batch(sub, device=cpu),
                              cpu)
            gaps = [theory.p1_objective(br.gamma[i], sub[i])
                    / max(scipy_objs[i], 1e-30) - 1.0 for i in range(b)]
            row["batch"].append({
                "batch_size": b, "scipy_loop_s": t_scipy,
                "torch_device_s": t_dev, "torch_device_first_call_s": t_first,
                "torch_host_cpu_s": t_cpu,
                "speedup_device": t_scipy / max(t_dev, 1e-9),
                "speedup_host_cpu": t_scipy / max(t_cpu, 1e-9),
                "objective_rel_gap_max": float(np.max(gaps))})
            print(f"n={n} b={b}: scipy {t_scipy:.3f} s, torch device "
                  f"{t_dev:.3f} s (first {t_first:.3f} s), host CPU "
                  f"{t_cpu:.3f} s, gap {np.max(gaps):.2e}", flush=True)
        out["sizes"].append(row)
    return out


def tradeoff_sweep(n: int = 10, seed: int = 0, points: int = 9) -> list:
    """Bias-variance decomposition along gamma = f * gamma_max (paper §III-A
    discussion): noise falls and bias rises as f grows."""
    prm = make_prm(n, seed)
    gm = theory.gamma_max(prm)
    rows = []
    for f in np.linspace(0.2, 1.0, points):
        gamma = f * gm
        z = theory.zeta_terms(gamma, prm)
        _, _, p = theory.participation(gamma, prm)
        rows.append({
            "bench": f"tradeoff_f{f:.2f}",
            "noise_var": z["noise"],
            "tx_var": z["transmission"],
            "bias": theory.bias_term(p, prm),
            "objective": theory.p1_objective(gamma, prm),
        })
    return rows


def bound_decomposition(n: int = 10, seed: int = 0,
                        rounds=(50, 200, 1000)) -> list:
    """Theorem-1 bound components for the SCA and zero-bias designs."""
    prm = make_prm(n, seed)
    res = sca.solve_sca(prm)
    rows = []
    for name, gamma in [("sca", res.gamma),
                        ("zero_bias", theory.zero_bias_gamma(prm))]:
        for t in rounds:
            b = theory.theorem1_bound(gamma, prm, init_gap=5.0, num_rounds=t)
            rows.append({
                "bench": f"bound_{name}_T{t}",
                "optimization": b["optimization"],
                "variance": b["variance"],
                "bias": b["bias"],
                "total": b["total"],
            })
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None)
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    report = {"tradeoff": tradeoff_sweep(), "bound": bound_decomposition(),
              "oracle": run()}
    for row in report["bound"] + report["oracle"]:
        print(json.dumps(row), flush=True)
    report["solver"] = solver_benchmark(device=a.device)
    if a.json:
        os.makedirs(os.path.dirname(os.path.abspath(a.json)), exist_ok=True)
        with open(a.json, "w") as f:
            json.dump(report, f, indent=1)
        print(f"# wrote {a.json}", flush=True)


if __name__ == "__main__":
    main()
