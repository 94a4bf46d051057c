"""SCA power-control design on the port (paper §III-B;
``examples/sca_power_control.py``).

    python -m repro_torch.examples.sca_power_control [--device D]

Designs (P1) power control for a batch of eight disk deployments in one
batched f64 solve (``repro_torch.solvers.solve_batch``, on the card),
prints each design's bias / variance split, and details the reference
deployment (seed 0) against the zero-bias and max-power designs, with the
SLSQP oracle (``core.sca.solve_sca``) as the cross-check.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import channel, sca, theory
from repro_torch.core.theory import OTAParams

SEEDS = tuple(range(8))
D = 814090


def make_prm(seed: int, n: int = 10):
    """(OTAParams, Deployment) of one realized disk deployment."""
    wcfg = channel.WirelessConfig(num_devices=n, seed=seed)
    dep = channel.deploy(wcfg)
    return OTAParams(d=D, gmax=10.0, es=wcfg.energy_per_sample,
                     n0=wcfg.noise_psd, gains=dep.gains, sigma_sq=np.zeros(n),
                     eta=0.05, lsmooth=1.0, kappa_sq=4.0), dep


def batch_rows(prms, res) -> list:
    """Per design of the batch: the objective and its bias / variance
    split, 2 eta L times the noise and transmission variances, and the
    spread of the participation levels."""
    rows = []
    for i, prm in enumerate(prms):
        z = theory.zeta_terms(res.gamma[i], prm)
        rows.append({
            "objective": float(res.objective[i]),
            "bias": float(theory.bias_term(res.p[i], prm)),
            "variance": float(2.0 * prm.eta * prm.lsmooth * z["total"]),
            "noise_var": float(2 * prm.eta * z["noise"]),
            "tx_var": float(2 * prm.eta * z["transmission"]),
            "p_spread": float(np.max(res.p[i]) - np.min(res.p[i]))})
    return rows


def comparison(prm, gamma) -> dict:
    """The (P1) objective, noise, transmission variance and bias of the
    SCA design against the zero-bias and max-power designs."""
    out = {}
    for name, g in (("sca (optimized)", gamma),
                    ("zero-bias", theory.zero_bias_gamma(prm)),
                    ("max-power", theory.gamma_max(prm))):
        z = theory.zeta_terms(g, prm)
        _, _, p = theory.participation(g, prm)
        out[name] = {"obj": float(theory.p1_objective(g, prm)),
                     "noise": float(z["noise"]),
                     "tx_var": float(z["transmission"]),
                     "bias": float(theory.bias_term(p, prm))}
    return out


def main(argv=None) -> dict:
    """The CLI: the batch of ``SEEDS``.  Returns the worlds, the batched
    result, the rows, the oracle's objective and the comparison."""
    from repro_torch import solvers
    from repro_torch.device import resolve_device
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    prms, deps = zip(*[make_prm(s) for s in SEEDS])
    res = solvers.solve_batch(list(prms), device=dev)

    rows = batch_rows(prms, res)
    print(f"batched SCA designs (one batched solve, {len(prms)} "
          "deployments):")
    print(f"{'seed':>5} {'objective':>10} {'bias':>10} {'variance':>10} "
          f"{'noise_var':>10} {'tx_var':>8} {'p_spread':>9}")
    for i, r in enumerate(rows):
        print(f"{i:>5} {r['objective']:>10.4f} {r['bias']:>10.5f} "
              f"{r['variance']:>10.4f} {r['noise_var']:>10.4f} "
              f"{r['tx_var']:>8.4f} {r['p_spread']:>9.4f}")

    prm, dep, gamma = prms[0], deps[0], res.gamma[0]
    print(f"\nreference deployment (seed {SEEDS[0]}): objective "
          f"{res.objective[0]:.4f}")
    oracle = sca.solve_sca(prm)
    print(f"scipy SLSQP oracle: {oracle.objective:.4f} "
          f"(rel gap {res.objective[0] / oracle.objective - 1.0:+.2e})")
    gm = theory.gamma_max(prm)
    print(f"\n{'device':>6} {'dist(m)':>8} {'Lambda':>10} {'gamma/gmax':>10} "
          f"{'p_m':>7}")
    for m in range(prm.num_devices):
        print(f"{m:>6} {dep.distances[m]:>8.0f} {dep.gains[m]:>10.2e} "
              f"{gamma[m] / gm[m]:>10.3f} {res.p[0][m]:>7.4f}")
    comp = comparison(prm, gamma)
    print("\ndesign comparison (P1 objective = 2 eta L zeta + bias):")
    for name, c in comp.items():
        print(f"  {name:16s} obj={c['obj']:8.4f} noise={c['noise']:8.3f} "
              f"tx_var={c['tx_var']:7.3f} bias={c['bias']:8.5f}")
    print("\n=> SCA accepts a small structured bias to cut receiver-noise "
          "variance: the paper's trade-off, designed for the whole "
          "deployment batch in one batched solve.")
    return {"prms": prms, "result": res, "rows": rows,
            "oracle": oracle.objective, "comparison": comp}


if __name__ == "__main__":
    main()
