"""The benchmark harness on the port, ported from ``benchmarks/run.py``:
one CSV row per paper table or figure.

    python -m repro_torch.run [--fig2-rounds N] [--fig2-every N]
        [--skip-fig2] [--seed S] [--device D]
    python -m repro_torch.run --smoke [--seed S] [--device D]

Rows are ``name,us_per_call,derived`` (``_csv``, the reference's).  ``main``
prints the reference's sections in its order: the SCA solver's quality
(``sca_bench.run``), the solver benchmark (``sca_bench.solver_rows``), the
bias-variance trade-off, the Theorem-1 bound, the scenario sweep, the
kernel rows (``kernel_bench.run``), Fig. 2 (``fig2.run`` at the paper's
full batch, ``save=False``: no artifact is written; ``fig2.summarize``
and its wall), and the roofline rows of the dry-run's records
(``roofline.run`` over ``experiments/dryrun_torch/``; without any, one
line says how to make them).

``--smoke`` (``smoke``) is the reference's engine-regression gate, its
five gates in its order, sizes and assertions: the 7-scheme Fig.-2 fleet
(8 minibatch rounds), the disk_rayleigh and disk_markov scenario fleets, a
batched SCA solve against the SLSQP oracle, an ``adaptive_sca`` fleet on
disk_markov that must re-design, and a cifar_conv fleet killed after one
chunk and resumed, bitwise the uninterrupted run (sharded over the
debug mesh where four or more slots are visible: the row
``smoke_cifar_conv_sharded4``, else ``smoke_cifar_conv_vmap``); it ends with
``# smoke OK``.  Its ``sca`` designs may be handed in, made ahead
(``design``; each is checked against its world).  Everything runs on the
card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import tempfile
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

SMOKE_SCENARIOS = ("disk_rayleigh", "disk_markov")
SOLVER_N, SOLVER_BATCH = 6, 4
ADAPTIVE = dict(scenario="disk_markov", d=10_000, hidden=32,
                samples_per_class=40, rounds=4, every=2)
CIFAR_KW = dict(channels=(8, 16), hidden=32, samples_per_class=24,
                test_per_class=10, alpha=1.0)
CIFAR_SCHEMES = ("ideal", "sca")
CIFAR_SEEDS = (0, 1)
DESIGNS = ("fig2", "scenarios", "adaptive", "cifar")


def _csv(row: dict) -> str:
    name = row.pop("bench", None) or row.pop("scheme", None) \
        or f"{row.pop('arch', '?')}_{row.pop('shape', '')}"
    us = row.pop("us_per_call", "")
    derived = ";".join(f"{k}={v}" for k, v in row.items())
    return f"{name},{us},{derived}"


class Made(NamedTuple):
    """A design made for the smoke: the worlds it was made for (their
    ``OTAParams``), the design (schemes, a scenario world, a batched
    solve) and the seconds it took."""
    prms: tuple
    value: object
    seconds: float


def _fig2_task():
    from repro_torch import tasks
    return tasks.get("paper_mlp", expect_runtime="fleet")


def _worlds(label: str, seed: int) -> tuple:
    """(the worlds of one design as ``OTAParams``, what makes it and what
    its gate runs on)."""
    from repro_torch import fig2, tasks
    from repro_torch.core import scenarios as scn
    if label == "fig2":
        task = _fig2_task()
        dep, prm, _ = fig2.build_world(task, seed)
        return (prm,), (task, dep, prm)
    if label == "scenarios":
        task = _fig2_task()
        prms = []
        for name in SMOKE_SCENARIOS:
            dep = scn.realize(scn.get_scenario(name), seed=seed)
            prms.append(scn.make_ota_params(
                dep, d=task.param_dim,
                gmax=float(task.defaults.get("gmax", 10.0)), eta=0.05,
                kappa_sq=4.0))
        return tuple(prms), task
    if label == "adaptive":
        sc = scn.get_scenario(ADAPTIVE["scenario"])
        dep = scn.realize(sc)
        prm = scn.make_ota_params(dep, d=ADAPTIVE["d"], gmax=10.0, eta=0.05,
                                  kappa_sq=4.0)
        return (prm,), (sc, dep, prm)
    if label == "cifar":
        task = tasks.get("cifar_conv", expect_runtime="fleet", **CIFAR_KW)
        dep, prm, td = fig2.build_world(task, seed)
        return (prm,), (task, dep, prm, td)
    raise ValueError(f"unknown design {label!r}; one of {DESIGNS}")


def _make(label: str, what, seed: int, dev):
    """The design of ``label`` for its world ``what``, made on ``dev``."""
    from repro_torch import fig2, scenario_sweep
    from repro_torch.core import power_control as pcm
    if label == "fig2":
        task, dep, prm = what
        return fig2.make_schemes(task, dep, prm, device=dev)
    if label == "scenarios":
        return scenario_sweep.design(
            SMOKE_SCENARIOS, d=what.param_dim,
            gmax=float(what.defaults.get("gmax", 10.0)), device=dev,
            seed=seed)
    if label == "adaptive":
        _, dep, prm = what
        return pcm.make_sca(dep, prm, device=dev)
    task, dep, prm, _ = what
    return fig2.make_schemes(task, dep, prm, list(CIFAR_SCHEMES), device=dev)


def design(label: str, seed: int = 0, device=None) -> Made:
    """One of the smoke's designs (``DESIGNS``), made on ``device`` (None:
    the card): the Fig.-2 world's seven schemes, the scenario fleets'
    world (``scenario_sweep.design``: one batched ``sca`` solve),
    ``adaptive_sca``'s initial ``sca`` design, or the cifar fleet's two
    schemes."""
    from repro_torch.device import resolve_device
    prms, what = _worlds(label, seed)
    t0 = time.time()
    value = _make(label, what, seed, resolve_device(device))
    return Made(prms, value, time.time() - t0)


def _take(designs: dict, label: str, seed: int, dev, walls) -> tuple:
    """(the design handed in for ``label``, checked against its world, or
    one made here, its seconds in ``walls["designs_s"]``; the world's
    objects, as ``_worlds`` gives them)."""
    prms, what = _worlds(label, seed)
    made = designs.get(label)
    if made is None:
        t0 = time.time()
        value = _make(label, what, seed, dev)
        walls.setdefault("designs_s", {})[label] = time.time() - t0
        return value, what
    from repro_torch.launch.train import same_world
    if len(prms) != len(made.prms) or not all(
            same_world(a, b) for a, b in zip(prms, made.prms)):
        raise ValueError(f"the {label} design handed in was made for "
                         f"another world than this smoke's")
    return made.value, what


def smoke(seed: int = 0, device=None, designs=None) -> dict:
    """The reference's engine-regression gate (see the module docstring),
    printing its rows.  ``designs``: {label: ``Made``} for any of
    ``DESIGNS``, made ahead; the rest are made here.  The solver gate's
    batched solve is what that gate tests, so it always runs here, on
    ``device``.  Returns {"rows": the CSV lines, "walls": seconds per
    gate, the batched solve's, the redesigns' and those of designs made
    here, "launches": the round tail's counts per gate
    (``scenario_sweep.ota_counts``)}."""
    from repro_torch import fig2, sca_bench, scenario_sweep, solvers
    from repro_torch.core import power_control as pcm, sca as sca_mod
    from repro_torch.core import scenarios as scn
    from repro_torch.data import partition, synthetic
    from repro_torch.device import resolve_device
    from repro_torch.fl.driver import run_fleet, run_fleet_task
    from repro_torch.fl.placement import ShardedPlacement
    from repro_torch.fl.server import FLRunConfig
    from repro_torch.launch.mesh import make_debug_mesh, visible_slots
    from repro_torch.models import mlp
    from repro_torch.models.param import init_params
    dev = resolve_device(device)
    designs = dict(designs or {})
    out = {"rows": [], "walls": {}, "launches": {}}
    walls = out["walls"]

    def emit(row):
        line = _csv(dict(row))
        out["rows"].append(line)
        print(line, flush=True)

    def gate(name, t0, before):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        walls[name] = time.time() - t0
        now = scenario_sweep.ota_counts()
        out["launches"][name] = {k: v - before[k] for k, v in now.items()}

    print("bench,us_per_call,derived", flush=True)
    t0, before = time.time(), scenario_sweep.ota_counts()
    pcs, (task, _, _) = _take(designs, "fig2", seed, dev, walls)
    hist, _ = fig2.run(num_rounds=8, eval_every=4, seed=seed, batch_size=64,
                       save=False, task=task, device=dev, designs=pcs)
    assert set(hist) == set(fig2.SCHEMES), sorted(hist)
    for name, rows in hist.items():
        accs = [r["acc"] for r in rows]
        assert np.all(np.isfinite(accs)), (name, accs)
        assert rows[-1]["active"] >= 1.0, (name, rows[-1])
        emit({"bench": f"smoke_fig2_{name}", "final_acc": round(accs[-1], 4)})
    gate("fig2", t0, before)
    print(f"# smoke fig2 fleet (7 schemes x 8 rounds): {walls['fig2']:.1f}s",
          flush=True)

    t0, before = time.time(), scenario_sweep.ota_counts()
    world, task = _take(designs, "scenarios", seed, dev, walls)
    rows = scenario_sweep.train_sweep(
        world, task, dev, scenario_names=SMOKE_SCENARIOS, num_rounds=4,
        eval_every=2, seed=seed, batch_size=64)
    for r in rows:
        assert np.isfinite(r["final_acc"]), r
        emit({"bench": f"smoke_{r['scenario']}_{r['scheme']}",
              "final_acc": r["final_acc"]})
    gate("scenarios", t0, before)
    print(f"# smoke scenario fleets: {walls['scenarios']:.1f}s", flush=True)

    # the batched SCA solver and the adaptive scheme: a small batch solve
    # must track the SLSQP oracle, and adaptive_sca must re-design inside
    # a Gauss-Markov fleet
    t0, before = time.time(), scenario_sweep.ota_counts()
    prms = [sca_bench.make_prm(SOLVER_N, s) for s in range(SOLVER_BATCH)]
    ts = time.time()
    br = solvers.solve_batch(prms, device=dev)
    walls["solver_s"] = time.time() - ts
    ref = sca_mod.solve_sca(prms[0]).objective
    gap = br.objective[0] / ref - 1.0
    assert abs(gap) < 1e-3, (br.objective[0], ref)
    assert np.all(np.isfinite(br.gamma)) and np.all(br.gamma > 0)
    emit({"bench": "smoke_solver_batch4", "gap_vs_scipy": f"{gap:.2e}",
          "objective": round(float(br.objective[0]), 4)})

    base, (sc, dep, prm) = _take(designs, "adaptive", seed, dev, walls)
    fp = scn.make_fading_process(dep, sc.dynamics)
    x, y, _, _ = synthetic.mnist_like(ADAPTIVE["samples_per_class"],
                                      seed=seed)
    data = partition.stack_shards(partition.partition_by_label(x, y, 10,
                                                               seed=seed))
    params0 = init_params(mlp.mlp_defs(hidden=ADAPTIVE["hidden"]), seed, dev)
    run_cfg = FLRunConfig(eta=0.05, num_rounds=ADAPTIVE["rounds"],
                          eval_every=ADAPTIVE["every"])
    pc = pcm.make_adaptive_sca(dep, prm, base=base, device=dev)
    hook, redesign_s = pc.redesign_fn, []

    def timed(*args):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ts = time.time()
        new = hook(*args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        redesign_s.append(time.time() - ts)
        return new
    res = run_fleet(mlp.mlp_loss, params0,
                    [dataclasses.replace(pc, redesign_fn=timed)], dep.gains,
                    data, run_cfg, fading=fp, flat=False, device=dev)
    walls["redesign_s"] = redesign_s
    assert res.designs is not None and len(res.designs) >= 2, res.designs
    g0, g1 = res.designs[0][1], res.designs[1][1]
    moved = float(np.max(np.abs(g1 - g0) / np.abs(g0)))
    assert moved > 1e-4, "adaptive re-design did not move the design"
    assert all(bool(torch.isfinite(v).all()) for v in res.params.values())
    emit({"bench": "smoke_adaptive_sca", "design_moved_rel": round(moved, 4),
          "redesigns": len(res.designs) - 1})
    gate("solver_adaptive", t0, before)
    print(f"# smoke solver + adaptive engine: {walls['solver_adaptive']:.1f}s"
          f" (redesigns {', '.join(f'{s:.1f}' for s in redesign_s)} s)",
          flush=True)

    # the task registry through the fleet stack, a kill and a resume
    # included: sharded over the debug mesh where four or more slots are
    # visible, vmapped otherwise
    t0, before = time.time(), scenario_sweep.ota_counts()
    pcs, (task_c, dep_c, _, td) = _take(designs, "cifar", seed, dev, walls)
    run_cfg = task_c.run_config(num_rounds=6, eval_every=2, batch_size=4,
                                seed=seed)
    placement, where = None, "vmap"
    slots = visible_slots(dev.type)
    if len(slots) >= 4:
        placement = ShardedPlacement(make_debug_mesh(2, 2, slots=slots))
        where = f"sharded{placement.num_devices}"
    kw = dict(task_data=td, seeds=CIFAR_SEEDS, flat=True,
              placement=placement, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "cifar_fleet")
        res_part = run_fleet_task(task_c, pcs, dep_c.gains, run_cfg, **kw,
                                  checkpoint_path=ck, max_chunks=1)  # kill
        rounds_part = res_part.traces["active_devices"].shape[-1]
        assert rounds_part < run_cfg.num_rounds, rounds_part
        res_res = run_fleet_task(task_c, pcs, dep_c.gains, run_cfg, **kw,
                                 checkpoint_path=ck, resume=True)
        res_full = run_fleet_task(task_c, pcs, dep_c.gains, run_cfg, **kw)
    assert set(res_res.params) == set(res_full.params) and all(
        torch.equal(res_res.params[k], res_full.params[k])
        for k in res_full.params), \
        "cifar_conv resume is not bitwise vs the uninterrupted fleet"
    final_acc = np.asarray(res_res.evals[-1][1]["acc"])
    assert final_acc.shape == (2, 2) and np.all(np.isfinite(final_acc))
    emit({"bench": f"smoke_cifar_conv_{where}",
          "final_acc_ideal": round(float(final_acc[0].mean()), 4),
          "resumed_rounds_done": rounds_part, "resume_bitwise": 1})
    gate("cifar", t0, before)
    print(f"# smoke cifar_conv task fleet ({where}, kill+resume): "
          f"{walls['cifar']:.1f}s", flush=True)
    print("# smoke OK", flush=True)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fig2-rounds", type=int, default=150)
    ap.add_argument("--fig2-every", type=int, default=15)
    ap.add_argument("--skip-fig2", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="the engine-regression gate: short fleets, asserts")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    from repro_torch.device import resolve_device
    dev = resolve_device(args.device)
    if args.smoke:
        smoke(seed=args.seed, device=dev)
        return

    print("bench,us_per_call,derived", flush=True)
    # the SCA solver's quality and walls (paper §III-B)
    from repro_torch import sca_bench
    for row in sca_bench.run(num_seeds=3, sizes=(10, 20)):
        print(_csv(row), flush=True)

    # the SLSQP loop against the batched solver, on the card and the host
    # (its progress lines go to stderr: stdout stays the CSV)
    with contextlib.redirect_stdout(sys.stderr):
        solver = sca_bench.solver_benchmark(device=dev)
    for row in sca_bench.solver_rows(solver):
        print(_csv(row), flush=True)

    # the bias-variance trade-off (paper §III-A, Theorem 1)
    for row in sca_bench.tradeoff_sweep():
        print(_csv(row), flush=True)

    # the Theorem-1 bound's terms
    for row in sca_bench.bound_decomposition():
        print(_csv(row), flush=True)

    # the scenario-family sweep
    from repro_torch import scenario_sweep
    for row in scenario_sweep.sweep(scenario_sweep.design(device=dev)):
        row["bench"] = f"scenario_{row.pop('scenario')}_{row.pop('scheme')}"
        for k in ("bias", "variance", "var_transmission", "var_noise",
                  "objective", "p_spread", "mean_participation",
                  "gain_spread_db"):
            row[k] = f"{row[k]:.4g}"
        print(_csv(row), flush=True)

    # the kernels against their plain versions
    from repro_torch import kernel_bench
    for row in kernel_bench.run(dev):
        print(_csv(row), flush=True)

    # Fig. 2, the paper's main experiment: the seven schemes as one fleet
    # at the paper's full batch
    if not args.skip_fig2:
        from repro_torch import fig2
        t0 = time.time()
        hist, _ = fig2.run(num_rounds=args.fig2_rounds,
                           eval_every=args.fig2_every, seed=args.seed,
                           batch_size=0, save=False, device=dev)
        wall = time.time() - t0
        for row in fig2.summarize(hist):
            row["bench"] = "fig2_" + row.pop("scheme")
            print(_csv(row), flush=True)
        print(f"# fig2 wall time: {wall:.1f}s", flush=True)

    roofline_section()


def roofline_section(directory: Optional[str] = None) -> None:
    """The roofline rows of the dry-run's records (``roofline.run``), in
    the reference's format; without any, the line that says how to make
    them."""
    from repro_torch import roofline
    rows = roofline.run(directory or roofline.ARTIFACT_DIR)
    for row in rows:
        row["bench"] = f"roofline_{row.pop('arch')}_{row.pop('shape')}"
        for k in ("compute_s", "memory_s", "collective_s",
                  "model_flops_per_device"):
            row[k] = f"{row[k]:.4g}"
        row["useful_flops_ratio"] = f"{row['useful_flops_ratio']:.3f}"
        print(_csv(row), flush=True)
    if not rows:
        print("# no dryrun artifacts yet — run: "
              "PYTHONPATH=src python -m repro_torch.launch.dryrun --all",
              flush=True)


if __name__ == "__main__":
    main()
