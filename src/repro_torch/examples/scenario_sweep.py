"""The scenario engine on the port: one FL task, four wireless worlds
(``examples/scenario_sweep.py``).

    python -m repro_torch.examples.scenario_sweep [--device D]

The paper fixes one scenario family (uniform disk, Rayleigh, i.i.d.
rounds).  The scenario engine (``repro_torch.core.scenarios``) composes
geometry x shadowing x fading family x round dynamics; this example sweeps
the four-family grid, prints each scenario's Theorem-1 bias / variance
split of its SCA design, and trains the paper's MLP on the two extremes
through ``fl.server.run_fl`` (a one-cell fleet on the scenario's fading
process, full batch).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import power_control as pcm, scenarios as scn, theory
from repro_torch.models import mlp

TRAIN_SCENARIOS = ("disk_rayleigh", "two_cluster")
ROUNDS, EVERY, SAMPLES = 60, 20, 500


def scenario_world(name: str, d: int = mlp.PARAM_DIM):
    """(scenario, deployment, OTAParams) of one registered scenario."""
    sc = scn.get_scenario(name)
    dep = scn.realize(sc)
    return sc, dep, scn.make_ota_params(dep, d=d, gmax=10.0, eta=0.05,
                                        kappa_sq=4.0)


def theory_rows(names=scn.SWEEP_FAMILIES, d: int = mlp.PARAM_DIM,
                device=None, designs=None) -> list:
    """Per scenario, its SCA design's bias, variance and (P1) objective,
    the deployment's gain spread and the design (``scheme``).  ``designs``: {name: the scenario's
    ``sca`` scheme}, else designed here on ``device``."""
    rows = []
    for name in names:
        _, dep, prm = scenario_world(name, d)
        pc = (designs or {}).get(name) or pcm.make_power_control(
            "sca", dep, prm, device=device)
        z = theory.zeta_terms(pc.gamma, prm)
        bias = theory.bias_term(pc.p, prm)
        rows.append({"scenario": name, "fading": dep.fading_spec.family,
                     "gain_spread_db": float(10 * np.log10(
                         dep.gains.max() / dep.gains.min())),
                     "bias": float(bias), "variance": float(z["total"]),
                     "objective": float(2 * prm.eta * z["total"] + bias),
                     "scheme": pc})
    return rows


def train(names=TRAIN_SCENARIOS, samples_per_class: int = SAMPLES,
          hidden: int = mlp.HIDDEN_DIM, rounds: int = ROUNDS,
          every: int = EVERY, device=None, designs=None) -> dict:
    """The MLP trained with each scenario's SCA design on its fading
    process, full batch: {name: ``run_fl``'s history}."""
    from repro_torch.data import partition, synthetic
    from repro_torch.device import resolve_device
    from repro_torch.fl.server import FLRunConfig, run_fl
    from repro_torch.models.param import init_params, param_count
    dev = resolve_device(device)
    x, y, xt, yt = synthetic.mnist_like(samples_per_class, seed=0)
    data = partition.stack_shards(partition.partition_by_label(x, y, 10,
                                                               seed=0))
    defs = mlp.mlp_defs(hidden=hidden)
    params0 = init_params(defs, 0, dev)
    xt_d, yt_d = torch.as_tensor(xt, device=dev), torch.as_tensor(yt,
                                                                  device=dev)
    out = {}
    for name in names:
        sc, dep, prm = scenario_world(name, param_count(defs))
        pc = (designs or {}).get(name) or pcm.make_power_control(
            "sca", dep, prm, device=dev)
        run_cfg = FLRunConfig(eta=0.05, num_rounds=rounds, eval_every=every)
        _, out[name] = run_fl(
            mlp.mlp_loss, params0, pc, dep.gains, data, run_cfg,
            eval_fn=lambda p: {"acc": mlp.accuracy(p, xt_d, yt_d)},
            fading=scn.make_fading_process(dep, sc.dynamics), device=dev)
    return out


def main(argv=None) -> dict:
    from repro_torch.device import resolve_device
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    # 1. how the bias-variance trade-off moves per scenario
    rows = theory_rows(device=dev)
    print(f"{'scenario':16s} {'fading':10s} {'gainspread':>10s} "
          f"{'bias':>10s} {'variance':>10s} {'objective':>10s}")
    for r in rows:
        print(f"{r['scenario']:16s} {r['fading']:10s} "
              f"{r['gain_spread_db']:9.1f}dB {r['bias']:10.3g} "
              f"{r['variance']:10.3g} {r['objective']:10.3g}")
    # 2. the MLP on the baseline and on the clustered extreme
    hists = train(device=dev, designs={r["scenario"]: r["scheme"]
                                       for r in rows})
    for name, hist in hists.items():
        traj = " -> ".join(f"{h['acc']:.3f}" for h in hist)
        grad0 = float(hist.traces["grad_norm_mean"][0])
        print(f"sca on {name:16s} acc: {traj}  (round-0 grad norm "
              f"{grad0:.2f})")
    return {"theory": rows, "train": hists}


if __name__ == "__main__":
    main()
