"""Fig.-2 reproduction on the port: test accuracy and global loss vs FL
rounds for all seven schemes, run as ONE fleet on the GPU.

    python -m repro_torch.fig2 [--task paper_mlp|cifar_conv] [--rounds 150]
        [--every 10] [--batch B] [--uplink f32|bf16|int8] [--unfused]
        [--seed 0] [--checkpoint] [--resume] [--max-chunks N]
        [--telemetry] [--legacy] [--bench] [--json PATH]
        [--population P --cohort N [--cohort-rounds R] [--no-stream]]
        [--device cuda]

A port of the fleet branch of ``benchmarks/fig2.py::run``; the workload
comes from the task registry (``repro_torch.tasks``).  The default is the
minibatch / flat mode, whose rounds go through kernel K1 (or K2 with
``--unfused``), at the task's preferred minibatch (cifar_conv: 32); a task
whose preferred mode is the full batch (paper_mlp) runs minibatch 128,
the reference's ``--bench`` batch, unless ``--batch 0`` asks for the
paper's full-batch protocol, which aggregates leaf by leaf.
``--checkpoint`` saves the fleet at every chunk boundary under the task's
artifact directory, ``--resume`` continues from that checkpoint (bitwise
equal to an uninterrupted run), and ``--max-chunks N`` stops after N
chunks.  ``--telemetry`` writes the event log (``events.jsonl``) and the
``bv_*`` diagnostic traces into the task's artifact directory; render it
with ``python -m repro_torch.telemetry.report <dir>``.  ``--legacy`` runs
the historical host loop (``fl.server.run_fl_legacy``) one scheme at a
time.  Writes ``experiments/<artifact tag>/histories_seed<seed>.json``
(paper_mlp: ``fig2_torch``; cifar_conv: ``cifar``).

``--population P`` runs the fleet in population mode: each chunk on a
``--cohort``-sized draw from a P-device parametric population
(``make_population``: disk, log-normal shadowing, traffic-weighted
Gumbel-top-k sampling), redrawn every ``--cohort-rounds`` rounds, the
next cohort staged on a host thread while the current chunk runs
(``--no-stream`` serializes the same stages: identical numbers).

``--bench`` is the reference's engine-vs-legacy benchmark (``benchmark``):
the legacy loop at full batch, the fleet at full batch and the fleet at
minibatch 128, with ``wall_s``, ``speedup`` and ``equivalence`` in the
keys of ``benchmarks/bench_schema.json``.  ``--bench --population P``
runs ``population_benchmark`` instead: ``adaptive_sca`` on P devices,
stream vs serial, and the full-participation identity.  Both write JSON
only to ``--json`` (nothing when it is not given): the report condensed to
the schema's summary (``bench_summary``), checked by
``repro_torch.validate_bench`` before it is written, and the whole report
beside it (``<name>.report.json``).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import tasks, validate_bench
from repro_torch.core import channel, power_control as pcm
from repro_torch.core import scenarios as scn
from repro_torch.core.theory import OTAParams
from repro_torch.device import resolve_device
from repro_torch.fl.driver import run_fleet_task
from repro_torch.fl.server import run_fl_legacy
from repro_torch.kernels import ref, round_step
from repro_torch.kernels.ops import UPLINK_DTYPES
from repro_torch.scenario_sweep import bitwise
from repro_torch.telemetry import Telemetry

SCHEMES = ["ideal", "opc", "sca", "lcpc", "vanilla", "bbfl_interior",
           "bbfl_alternative"]
BENCH_BATCH = 128
ROOT = Path(__file__).resolve().parents[2]


def _task(task):
    """A task name (resolved through the registry, fleet runtime) or a
    Task."""
    if isinstance(task, str):
        return tasks.get(task, expect_runtime="fleet")
    if task.runtime != "fleet":
        raise ValueError(f"task {task.name!r} is a {task.runtime!r}-runtime "
                         f"workload; this benchmark needs a fleet task")
    return task


def default_batch(task) -> int:
    """The task's preferred minibatch, or ``BENCH_BATCH`` for a task whose
    preferred mode is the full batch (paper_mlp's 0)."""
    return int(task.defaults.get("batch_size", 0)) or BENCH_BATCH


def artifact_dir(task) -> Path:
    task = _task(task)
    return ROOT / "experiments" / (task.artifact_tag or task.name)


def build_world(task, seed: int = 0, num_devices=None):
    """Deployment + OTA design constants + task data.  The deployment is
    seeded independently of the data seed (one wireless world across data
    seeds), as in the reference.  ``num_devices`` overrides the task's
    device count: population runs design their schemes for a cohort-sized
    world, not the shard count."""
    wcfg = channel.WirelessConfig(
        num_devices=num_devices or task.num_devices, seed=0)
    dep = channel.deploy(wcfg)
    td = task.build_data(seed)
    prm = OTAParams(d=task.param_dim,
                    gmax=float(task.defaults.get("gmax", 10.0)),
                    es=wcfg.energy_per_sample, n0=wcfg.noise_psd,
                    gains=dep.gains, sigma_sq=np.zeros(wcfg.num_devices),
                    eta=0.05, lsmooth=1.0, kappa_sq=4.0)
    return dep, prm, td


def make_population(size: int, sampling: str = "traffic",
                    seed: int = 0) -> scn.Population:
    """The parametric serving population of --population runs: disk
    geometry with log-normal shadowing, i.i.d. Rayleigh fading (the
    fleet's fading=None fast path) and heavy-tailed traffic-weighted
    cohort draws.  Lazy: 1M devices cost nothing until a cohort
    materializes them."""
    spec = scn.PopulationSpec(size=size, shadowing=scn.ShadowingSpec(),
                              sampling=sampling, seed=seed)
    return scn.Population(spec=spec)


def make_schemes(task, dep, prm, names=SCHEMES, device=None) -> list:
    """One scheme per name, each designed at the task's step size (eta
    enters the SCA objective); ``sca``'s solver runs on ``device``
    (default: the card)."""
    return [pcm.make_power_control(
        n, dep, prm.replace(eta=task.eta_for(n, float(prm.eta))),
        **({"device": device} if n == "sca" else {}))
        for n in names]


def histories(res) -> dict:
    """FLResult (seed axis S=1) -> {scheme: [eval rows]}."""
    out = {}
    for i, name in enumerate(res.names):
        out[name] = [{"acc": float(ev["acc"][i, 0]),
                      "global_loss": float(ev["global_loss"][i, 0]),
                      "round": t, "scheme": name,
                      "active": float(res.traces["active_devices"][i, 0, t]),
                      "wall": res.wall}
                     for t, ev in res.evals]
    return out


def run(num_rounds: int = 150, eval_every: int = 10, seed: int = 0,
        schemes=SCHEMES, batch_size=None, task="paper_mlp",
        uplink_dtype: str = "f32", fuse_round=None, log: bool = False,
        save: bool = True, out_dir=None, checkpoint_path=None,
        resume: bool = False, max_chunks=None, designs=None, fading=None,
        engine: str = "fleet", population: int = 0, cohort=None,
        cohort_rounds=None, stream: bool = True, telemetry=None,
        device=None):
    """Histories of every scheme on ``task`` (a registered name or a Task;
    default paper_mlp at full width); returns (histories, FLResult) (the
    FLResult is None for the legacy engine).  ``batch_size > 0`` runs the
    flat minibatch mode, 0 the full-batch per-leaf mode, None
    ``default_batch(task)``.  ``telemetry`` (fleet engine only): True
    writes the event log and the ``bv_*`` traces into the task's artifact
    dir (``out_dir`` when given) with the world's kappa^2; a run-dir string
    or a ``telemetry.Telemetry`` passes to the driver as it is.
    ``checkpoint_path`` / ``resume`` / ``max_chunks`` and ``fading`` (a
    ``core.scenarios`` process on this world's gains) pass to the driver.
    ``designs``: the schemes already designed for this task's world
    (``make_schemes``), which does not depend on the data seed, so a sweep
    over seeds designs them once.  ``engine="legacy"`` runs
    ``run_fl_legacy`` one scheme at a time.  ``population > 0`` runs the
    fleet in population mode: ``cohort`` devices a round (default the
    task's device count) drawn from ``make_population(population)``, the
    schemes designed for the cohort-sized world."""
    dev = resolve_device(device)
    task = _task(task)
    if batch_size is None:
        batch_size = default_batch(task)
    telemetry = telemetry or None
    if telemetry is not None and engine != "fleet":
        raise ValueError("telemetry needs the fleet engine")
    if engine == "legacy":
        fleet_only = {"uplink_dtype": uplink_dtype != "f32",
                      "fuse_round": fuse_round is not None,
                      "fading": fading is not None,
                      "checkpoint_path": checkpoint_path is not None,
                      "resume": resume, "max_chunks": max_chunks is not None}
        if any(fleet_only.values()):
            raise ValueError("the legacy loop runs f32, fused, i.i.d. "
                             "Rayleigh and without checkpoints; drop "
                             + ", ".join(k for k, v in fleet_only.items()
                                         if v))
    pop_kw = {}
    if population:
        if engine != "fleet":
            raise ValueError("population mode needs the fleet engine")
        cohort = int(cohort or task.num_devices)
        pop_kw = dict(population=make_population(int(population)),
                      cohort_size=cohort, cohort_rounds=cohort_rounds,
                      stream=stream)
    dep, prm, td = build_world(task, seed, num_devices=cohort)
    if telemetry is True:
        telemetry = Telemetry(run_dir=str(out_dir if out_dir is not None
                                          else artifact_dir(task)),
                              kappa_sq=float(prm.kappa_sq))
    run_cfg = task.run_config(num_rounds=num_rounds, eval_every=eval_every,
                              seed=seed, batch_size=batch_size,
                              uplink_dtype=uplink_dtype)
    pcs = designs if designs is not None \
        else make_schemes(task, dep, prm, schemes, device=dev)
    if engine == "legacy":
        params0, ev = task.init_params(seed, dev), task.make_eval(td, dev)
        hist = {}
        for pc in pcs:
            eta = task.eta_for(pc.name, 0.05)
            rc = task.run_config(eta=eta, num_rounds=num_rounds,
                                 eval_every=eval_every, seed=seed,
                                 batch_size=batch_size)
            _, hist[pc.name] = run_fl_legacy(task.loss_fn, params0, pc,
                                             dep.gains, td.train, rc, ev,
                                             log=log, device=dev)
        res = None
    elif engine == "fleet":
        res = run_fleet_task(task, pcs, dep.gains, run_cfg, task_data=td,
                             flat=batch_size > 0, fuse_round=fuse_round,
                             log=log, checkpoint_path=checkpoint_path,
                             resume=resume, max_chunks=max_chunks,
                             fading=fading, telemetry=telemetry, device=dev,
                             **pop_kw)
        hist = histories(res)
    else:
        raise ValueError(f"unknown engine {engine!r}")
    if save:
        out = Path(out_dir) if out_dir is not None else artifact_dir(task)
        os.makedirs(out, exist_ok=True)
        with open(out / f"histories_seed{seed}.json", "w") as f:
            json.dump(hist, f, indent=1)
    return hist, res


def _history_deltas(a: dict, b: dict) -> dict:
    """Max |delta| between two scheme -> history maps at each eval metric."""
    return {metric: max(abs(ra[metric] - rb[metric])
                        for name in a for ra, rb in zip(a[name], b[name]))
            for metric in ("acc", "global_loss")}


def _card(dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def benchmark(num_rounds: int = 150, eval_every: int = 15, seed: int = 0,
              batch_size: int = BENCH_BATCH, task="paper_mlp",
              log: bool = True, designs=None, device=None) -> dict:
    """Engine-vs-legacy wall clock of the full scheme grid (the
    reference's ``benchmarks.fig2.benchmark``): three runs of the 7-scheme
    x ``num_rounds`` grid --

      legacy          the host loop, full batch, one scheme at a time
      fleet_fullbatch one fleet, full batch: the same arithmetic and draws
                      as legacy, history deltas recorded
      fleet_minibatch one fleet, ``batch_size`` minibatch on the fused
                      flat tail (K1 on the card)

    -- each timed by the same outer clock around its ``run`` call (world,
    data and eval set-up included).  The schemes are designed once, before
    the clocks (``designs``, or ``make_schemes`` on the card): the port's
    f64 ``sca`` solve takes seconds, and all three runs use the same
    designs, as the reference's three designs agree.  The fleet rows carry
    the driver's compile/exec split (the first chunk against the rest).
    Returns the report (keys of ``benchmarks/bench_schema.json``:
    ``wall_s``, ``speedup``)."""
    dev = resolve_device(device)
    task = _task(task)
    if designs is None:
        dep, prm, _ = build_world(task, seed)
        designs = make_schemes(task, dep, prm, device=dev)
    cfg = dict(num_rounds=num_rounds, eval_every=eval_every, seed=seed,
               save=False, task=task, designs=designs, device=dev)
    walls, out = {}, {}
    for label, kw in (("legacy_loop_fullbatch",
                       dict(engine="legacy", batch_size=0)),
                      ("fleet_fullbatch", dict(batch_size=0)),
                      ("fleet_minibatch", dict(batch_size=batch_size))):
        _sync(dev)
        t0 = time.time()
        out[label] = run(**cfg, **kw)
        _sync(dev)
        walls[label] = time.time() - t0
        res = out[label][1]
        if res is not None:
            walls[label + "_compile"] = res.wall_compile
            walls[label + "_exec"] = res.wall_exec
        if log:
            print(f"{label}: {walls[label]:.2f} s", flush=True)
    legacy, full, mb = (out[k][0] for k in ("legacy_loop_fullbatch",
                                            "fleet_fullbatch",
                                            "fleet_minibatch"))
    wall_legacy = walls["legacy_loop_fullbatch"]
    report = {
        "grid": {"task": task.name, "schemes": list(SCHEMES),
                 "num_rounds": num_rounds, "eval_every": eval_every,
                 "seed": seed, "bench_batch_size": batch_size,
                 "device": _card(dev), "backend": "torch-" + dev.type},
        "wall_s": walls,
        "speedup": {
            "engine_vs_legacy": wall_legacy / walls["fleet_minibatch"],
            "fullbatch_engine_vs_legacy":
                wall_legacy / walls["fleet_fullbatch"],
            "engine_exec_vs_legacy":
                wall_legacy / max(walls["fleet_minibatch_exec"], 1e-9)},
        "equivalence": {
            "note": "fleet_fullbatch vs legacy at identical seeds and draws",
            "max_abs_delta": _history_deltas(legacy, full)},
        "final_acc": {label: {n: h[n][-1]["acc"] for n in h}
                      for label, h in (("legacy", legacy),
                                       ("fleet_fullbatch", full),
                                       ("fleet_minibatch", mb))},
    }
    if log:
        print(json.dumps(report["speedup"], indent=1), flush=True)
    return report


def population_benchmark(task="paper_mlp", size: int = 1_000_000,
                         cohort: int = 50, num_rounds: int = 48,
                         eval_every: int = 16, cohort_rounds: int = 1,
                         seed: int = 0, batch_size: int = BENCH_BATCH,
                         log: bool = True, full_schemes=None,
                         device=None) -> dict:
    """Streaming-cohort throughput (the reference's
    ``benchmarks.fig2.population_benchmark``).

    One ``adaptive_sca`` scheme over a ``size``-device traffic-weighted
    population at ``cohort`` devices a round, redrawn and re-designed on
    the incoming cohort's statistical CSI every ``cohort_rounds`` rounds
    (the default: every round, the hardest cadence).  The same fleet runs
    with stream on and off; the two must agree bitwise (params, traces,
    cohorts, designs), and their exec walls say how much staging the
    overlap hid.  In population mode the first chunk is re-designed for
    its cohort before round 0, so the scheme's own initial design is never
    used: it is the host SLSQP design, not a second solve.  Also checks
    the full-participation identity: ``Population.from_deployment`` of the
    task's own deployment, cohort = N, ``sca``, 6 rounds, is bitwise the
    plain fleet (``full_schemes``: that world's ``sca``, else designed
    here).  Records each run's K1 launches."""
    dev = resolve_device(device)
    task = _task(task)
    pop = make_population(size)
    dep, prm, td = build_world(task, seed, num_devices=cohort)
    prm_a = prm.replace(eta=task.eta_for("adaptive_sca", float(prm.eta)))
    pcs = [pcm.make_adaptive_sca(dep, prm_a, base=pcm.make_sca(
        dep, prm_a, method="scipy"))]
    run_cfg = task.run_config(num_rounds=num_rounds, eval_every=eval_every,
                              seed=seed, batch_size=batch_size)
    params0, evals = task.init_params(seed, dev), task.make_eval(td, dev)
    kw = dict(task_data=td, params=params0, eval_fn=evals,
              flat=batch_size > 0, population=pop, cohort_size=cohort,
              cohort_rounds=cohort_rounds, device=dev)
    launches, res = {}, {}
    for label, stream in (("stream", True), ("serial", False)):
        before = (round_step.ota_round_step.launches,
                  ref.ota_round_step_ref.calls)
        res[label] = run_fleet_task(task, pcs, dep.gains, run_cfg, **kw,
                                    stream=stream)
        launches[label] = {
            "ota_round_step": round_step.ota_round_step.launches - before[0],
            "plain_round_step": ref.ota_round_step_ref.calls - before[1]}
    st, se = res["stream"], res["serial"]
    stream_eq = bitwise(st, se) \
        and all(np.array_equal(a[1], b[1]) and a[0] == b[0]
                for x, y in ((st.cohorts, se.cohorts),
                             (st.designs, se.designs))
                for a, b in zip(x, y)) \
        and len(st.cohorts) == len(se.cohorts) \
        and len(st.designs) == len(se.designs)
    if log:
        print(f"population {size} / cohort {cohort}: stream exec "
              f"{st.wall_exec:.2f} s (staged {st.wall_stage:.2f} s), "
              f"serial exec {se.wall_exec:.2f} s (staged "
              f"{se.wall_stage:.2f} s)", flush=True)

    # full participation: deployment-as-population, cohort == N
    dep0, prm0, _ = build_world(task, seed)
    pcs0 = full_schemes if full_schemes is not None \
        else make_schemes(task, dep0, prm0, ["sca"], device=dev)
    run0 = task.run_config(num_rounds=6, eval_every=3, seed=seed,
                           batch_size=batch_size)
    kw0 = dict(task_data=td, params=params0, eval_fn=evals,
               flat=batch_size > 0, device=dev)
    before = round_step.ota_round_step.launches
    plain = run_fleet_task(task, pcs0, dep0.gains, run0, **kw0)
    full = run_fleet_task(task, pcs0, dep0.gains, run0, **kw0,
                          population=scn.Population.from_deployment(dep0),
                          cohort_size=task.num_devices, stream=False)
    launches["full_participation"] = {
        "ota_round_step": round_step.ota_round_step.launches - before}
    full_bitwise = bitwise(plain, full)

    report = {
        "config": {"task": task.name, "population": size, "cohort": cohort,
                   "num_rounds": num_rounds, "eval_every": eval_every,
                   "cohort_rounds": cohort_rounds, "seed": seed,
                   "batch_size": batch_size, "scheme": "adaptive_sca",
                   "sampling": "traffic", "device": _card(dev),
                   "backend": "torch-" + dev.type},
        "wall_s": {"stream_exec": st.wall_exec, "serial_exec": se.wall_exec,
                   "stream_stage": st.wall_stage,
                   "serial_stage": se.wall_stage,
                   "stream_compile": st.wall_compile,
                   "stream_wall": st.wall, "serial_wall": se.wall},
        "stage_chunks_s": {"stream": list(st.stage_walls),
                           "serial": list(se.stage_walls)},
        "round_ms": {label: 1e3 * sum(sec for _, sec in r.chunk_walls)
                     / sum(n for n, _ in r.chunk_walls)
                     for label, r in res.items()},
        # the rounds after the first chunk over the exec wall, which
        # leaves that chunk out (the reference divides all the rounds)
        "rounds_per_sec": (num_rounds - st.chunk_walls[0][0])
        / max(st.wall_exec, 1e-9),
        "overlap_saving_s": se.wall_exec - st.wall_exec,
        "stream_bitwise": bool(stream_eq),
        "full_cohort_bitwise": bool(full_bitwise),
        "launches": launches,
    }
    if log:
        print(json.dumps({k: report[k] for k in
                          ("rounds_per_sec", "overlap_saving_s",
                           "stream_bitwise", "full_cohort_bitwise",
                           "launches")}, indent=1), flush=True)
    report["result"] = st
    return report


def bench_summary(report: dict, task_name: str, source: str) -> dict:
    """A ``--bench`` report condensed to the summary that
    ``bench_schema.json`` describes (the reference's
    ``write_bench_summary``): the engine benchmark's grid, walls and
    speedups, or the population benchmark as its ``population`` section."""
    summary = {"source": source, "task": task_name}
    if "population" in report.get("config", {}):
        summary["population"] = {k: v for k, v in report.items()
                                 if k != "result"}
        return summary
    summary["grid"] = {k: report["grid"][k]
                       for k in ("num_rounds", "eval_every",
                                 "bench_batch_size", "backend", "device")}
    summary["wall_s"] = report["wall_s"]
    summary["speedup"] = report["speedup"]
    return summary


def write_bench(report: dict, task_name: str, path: str) -> None:
    """Write ``bench_summary(report)`` to ``path`` once
    ``validate_bench`` passes it (a ValueError names the violations), and
    the whole report beside it as ``<stem>.report.json``."""
    path = Path(path).resolve()
    summary = bench_summary(report, task_name, "repro_torch.fig2 --bench")
    errors = validate_bench.validate_summary(summary)
    if errors:
        raise ValueError(f"{path.name} would violate the bench schema: "
                         f"{errors}")
    os.makedirs(path.parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(summary, f, indent=1)
    with open(path.with_name(path.stem + ".report.json"), "w") as f:
        json.dump({k: v for k, v in report.items() if k != "result"}, f,
                  indent=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default="paper_mlp",
                    help="registered fleet workload "
                         f"({'|'.join(tasks.names(runtime='fleet'))})")
    ap.add_argument("--checkpoint", action="store_true",
                    help="save the fleet at chunk boundaries under the "
                         "task's artifact directory")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the task's checkpoint if present "
                         "(implies --checkpoint)")
    ap.add_argument("--max-chunks", type=int, default=None,
                    help="stop after N chunks (with --checkpoint: a clean "
                         "mid-run stop that --resume completes)")
    ap.add_argument("--legacy", action="store_true",
                    help="run the historical host loop, one scheme at a "
                         "time, instead of the fleet")
    ap.add_argument("--bench", action="store_true",
                    help="the engine-vs-legacy benchmark; with "
                         "--population, the population benchmark")
    ap.add_argument("--json", default=None,
                    help="where --bench writes its report")
    ap.add_argument("--population", type=int, default=0,
                    help="population mode: the population's size "
                         "(0 = full participation)")
    ap.add_argument("--cohort", type=int, default=None,
                    help="active devices per round under --population "
                         "(default: the task's device count; 50 under "
                         "--bench)")
    ap.add_argument("--cohort-rounds", type=int, default=None,
                    help="redraw the cohort every R rounds (default: once "
                         "per chunk; 1 under --bench)")
    ap.add_argument("--no-stream", action="store_true",
                    help="stage cohorts serially instead of beside the "
                         "running chunk (identical numbers)")
    ap.add_argument("--telemetry", action="store_true",
                    help="write events.jsonl and the bias-variance traces "
                         "into the task's artifact dir; render with "
                         "python -m repro_torch.telemetry.report <dir>")
    ap.add_argument("--rounds", type=int, default=None,
                    help="default 150; 48 under --bench --population")
    ap.add_argument("--every", type=int, default=None,
                    help="eval cadence (default 10; 15 under --bench, 16 "
                         "under --bench --population)")
    ap.add_argument("--batch", type=int, default=None,
                    help="minibatch size, 0 = full batch (default: the "
                         "task's preferred size, or "
                         f"{BENCH_BATCH} where that is the full batch)")
    ap.add_argument("--uplink", default="f32", choices=UPLINK_DTYPES)
    ap.add_argument("--unfused", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    try:
        task = _task(a.task)
    except (KeyError, ValueError) as e:
        raise SystemExit(str(e))
    if a.population and a.legacy:
        raise SystemExit("--population applies to the fleet; drop --legacy")
    if (a.checkpoint or a.resume) and (a.legacy or a.bench):
        raise SystemExit("--checkpoint/--resume apply to the fleet run "
                         "only; drop --legacy/--bench")
    if a.legacy and (a.uplink != "f32" or a.unfused):
        raise SystemExit("--uplink/--unfused apply to the fleet; the legacy "
                         "loop runs f32, fused; drop --legacy")
    if a.telemetry and (a.legacy or a.bench):
        raise SystemExit("--telemetry applies to the fleet run only; drop "
                         "--legacy/--bench")
    # --bench runs the reference's bench batch whatever the task prefers
    batch = a.batch if a.batch is not None \
        else BENCH_BATCH if a.bench else default_batch(task)
    if a.bench:
        if a.population:
            report = population_benchmark(
                task=task, size=a.population, cohort=a.cohort or 50,
                num_rounds=a.rounds or 48, eval_every=a.every or 16,
                cohort_rounds=a.cohort_rounds or 1, seed=a.seed,
                batch_size=batch, device=a.device)
        else:
            report = benchmark(num_rounds=a.rounds or 150,
                               eval_every=a.every or 15, seed=a.seed,
                               batch_size=batch, task=task, device=a.device)
        if a.json:
            write_bench(report, task.name, a.json)
            print(f"# wrote {a.json} (schema-checked) and its "
                  ".report.json", flush=True)
        return
    ckpt_path = None
    if a.checkpoint or a.resume:
        ckpt_path = str(artifact_dir(task) / f"fleet_seed{a.seed}")
    hist, res = run(num_rounds=a.rounds or 150, eval_every=a.every or 10,
                    seed=a.seed, batch_size=batch, task=task,
                    uplink_dtype=a.uplink,
                    fuse_round=False if a.unfused else None, log=True,
                    checkpoint_path=ckpt_path, resume=a.resume,
                    max_chunks=a.max_chunks,
                    engine="legacy" if a.legacy else "fleet",
                    population=a.population, cohort=a.cohort,
                    cohort_rounds=a.cohort_rounds, stream=not a.no_stream,
                    telemetry=a.telemetry, device=a.device)
    for name, h in hist.items():
        print(f"{name:>17}: acc {h[-1]['acc']:.4f}  "
              f"global_loss {h[-1]['global_loss']:.4f}")
    if res is not None:
        first = (f" (first chunk run {res.chunk_walls[0][1]:.2f} s)"
                 if res.chunk_walls else " (no chunk left to run)")
        print(f"wall {res.wall:.2f} s{first}")


if __name__ == "__main__":
    main()
