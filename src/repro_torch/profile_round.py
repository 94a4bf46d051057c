"""Where a full-width fleet round's time goes, on the card.

    python -m repro_torch.profile_round [--rounds 20] [--batch 128] [--grid]

Runs the Fig.-2 fleet's main path (paper_mlp at full width, 7 schemes,
S = 1, minibatch, flat, fused, f32 uplink, no evals) three times: once to
warm up, once timed on the host clock (the driver synchronizes the device
at the end), once under ``torch.profiler``.  Prints the round wall, the
device time per round summed over every kernel the profiler saw, the
device's busy share (device time over the unprofiled wall: one stream, so
kernels do not overlap), kernel launches per round, and the kernels that
take the most device time.  The last line is one JSON object with those
numbers.  Needs a CUDA device.

``--grid`` profiles the scenario grid instead: ``scenario_sweep``'s 48
cells (the four ``SWEEP_FAMILIES`` x sca, lcpc, zero_bias x seeds 0-3),
full batch, flat, fused, no evals (``--batch`` is not used).  It also
times the round's gradients alone (``engine.make_gradients``, CUDA
events) as the grid takes them, one scenario's 12 cells at a time, and as
one vmap over all 48 cells: what the per-scenario split costs.
"""
from __future__ import annotations

import argparse
import collections
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import fig2
from repro_torch.card import median_ms
from repro_torch.device import resolve_device
from repro_torch.fl.driver import run_fleet
from repro_torch.fl.engine import make_gradients
from repro_torch.tasks.image import make_paper_mlp


def fig2_fleet(task, rounds, batch, dev):
    """(fleet(), cells, label, None) of the Fig.-2 fleet's main path."""
    dep, prm, td = fig2.build_world(task, 0)
    schemes = fig2.make_schemes(task, dep, prm)
    params = task.init_params(0, dev)
    run = task.run_config(num_rounds=rounds, eval_every=rounds,
                          batch_size=batch)
    etas = [task.eta_for(pc.name, run.eta) for pc in schemes]

    def fleet():
        return run_fleet(task.loss_fn, params, schemes, dep.gains, td.train,
                         run, None, etas=etas, flat=True, device=dev)
    return fleet, len(schemes), f"minibatch {batch}", None


def grid_fleet(task, rounds, dev):
    """(fleet(), cells, label, gradient timings) of the 48-cell grid."""
    from repro_torch import scenario_sweep as ss
    from repro_torch.core import scenarios as scn
    world = ss.design(scn.SWEEP_FAMILIES, device=dev)
    stack, pcs = ss.grid_world(world, scn.SWEEP_FAMILIES)
    td = task.build_data(0)
    params = task.init_params(0, dev)
    run = ss.run_config(task, rounds, rounds)

    def fleet():
        return run_fleet(task.loss_fn, params, pcs, None, td.train, run,
                         None, etas=[ss.ETA] * len(pcs), seeds=ss.SEEDS,
                         flat=True, scenarios=stack, device=dev)

    c = len(pcs) * len(ss.SEEDS)
    grads = make_gradients(task.loss_fn, run)
    x = torch.as_tensor(td.train[0], dtype=torch.float32, device=dev)
    y = torch.as_tensor(td.train[1], device=dev).long()
    cells = {k: v[None].expand((c,) + tuple(v.shape)).clone()
             for k, v in params.items()}
    cell_seed = torch.arange(c, device=dev) % len(ss.SEEDS)
    timing = {f"by_scenario_{len(stack)}x{c // len(stack)}_ms": median_ms(
                  lambda: grads(cells, x, y, None, cell_seed, len(stack)),
                  iters=5, batches=3, warmup=2),
              f"one_vmap_{c}_ms": median_ms(
                  lambda: grads(cells, x, y, None, cell_seed),
                  iters=5, batches=3, warmup=2)}
    return fleet, c, "full batch, scenario grid", timing


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--batch", type=int, default=fig2.BENCH_BATCH)
    ap.add_argument("--grid", action="store_true",
                    help="profile the 48-cell scenario grid")
    a = ap.parse_args(argv)
    dev = resolve_device(None)
    task = make_paper_mlp()
    fleet, cells, label, grad_ms = grid_fleet(task, a.rounds, dev) \
        if a.grid else fig2_fleet(task, a.rounds, a.batch, dev)

    fleet()
    t0 = time.time()
    fleet()
    wall_ms = 1e3 * (time.time() - t0) / a.rounds
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fleet()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device events; time "
                           "the round with CUDA events instead")
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    device_ms = sum(us for _, us in by_name.values()) / 1e3 / a.rounds
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    print(f"card {torch.cuda.get_device_name(0)}; {a.rounds} rounds, "
          f"C = {cells} cells, {label}")
    print(f"round wall {wall_ms:.3f} ms; device time {device_ms:.3f} ms per "
          f"round; busy share {device_ms / wall_ms:.3f}; "
          f"{len(kernels) / a.rounds:.1f} kernel launches per round")
    if grad_ms is not None:
        print(f"gradients alone, ms per call: {json.dumps(grad_ms)}")
    for name, (n, us) in top:
        print(f"  {us / 1e3 / a.rounds:8.4f} ms/round  {n / a.rounds:6.1f}"
              f" launches/round  {name[:100]}")
    print(json.dumps({
        "round_wall_ms": wall_ms, "device_ms_per_round": device_ms,
        "busy_share": device_ms / wall_ms,
        "launches_per_round": len(kernels) / a.rounds,
        "gradients_ms": grad_ms,
        "top": [{"name": name[:100], "ms_per_round": us / 1e3 / a.rounds,
                 "launches_per_round": n / a.rounds}
                for name, (n, us) in top]}))


if __name__ == "__main__":
    main()
