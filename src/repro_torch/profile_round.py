"""Where a full-width fleet round's time goes, on the card.

    python -m repro_torch.profile_round [--rounds 20] [--batch B] [--grid]
        [--task paper_mlp|cifar_conv]

Runs the Fig.-2 fleet's main path (``--task``'s model at full width,
paper_mlp by default, 7 schemes, S = 1, minibatch -- 128, or the task's
preferred size: cifar_conv's 32 -- flat, fused, f32 uplink, no evals)
three times: once to warm up, once timed on the host clock (the driver
synchronizes the device at the end), once under ``torch.profiler``.
Prints the round wall, the device time per round summed over every kernel
the profiler saw, the device's busy share (device time over the
unprofiled wall: one stream, so kernels do not overlap; the profiler adds
time to each kernel it traces, so with ~1,000 small kernels a round the
share can pass 1), kernel launches per round, and the kernels that take
the most device time.  It also times the round's gradients alone
(``engine.make_gradients``, CUDA events) with cuDNN deterministic, as
``resolve_device`` sets it, and with cuDNN's default algorithms, and how
far apart two calls land under each: what the determinism costs.  The
last line is one JSON object with those numbers.  Needs a CUDA device.

``--grid`` profiles the scenario grid instead: ``scenario_sweep``'s 48
cells (the four ``SWEEP_FAMILIES`` x sca, lcpc, zero_bias x seeds 0-3),
full batch, flat, fused, no evals (``--batch`` is not used).  It also
times the round's gradients alone (``engine.make_gradients``, CUDA
events) as the grid takes them, one scenario's 12 cells at a time, and as
one vmap over all 48 cells: what the per-scenario split costs.

``profile`` is the measurement itself, for other scripts (``chip_smoke.py``
reads the cifar round's launches through it); it also reports how far
apart its first two runs' params landed (0: bitwise equal).
"""
from __future__ import annotations

import argparse
import collections
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile as profile_ctx

from repro_torch import fig2, tasks
from repro_torch.card import median_ms
from repro_torch.device import resolve_device
from repro_torch.fl.driver import run_fleet
from repro_torch.fl.engine import make_gradients


def fig2_fleet(task, rounds, batch, dev, schemes=None):
    """(fleet(), cells, label, gradient timings) of the Fig.-2 fleet's main
    path (``schemes``: the seven designed for the task's world, default
    designed here).  The shards go to the card once, here, so the
    profiled runs hold no host-to-device copy of the data set."""
    dep, prm, td = fig2.build_world(task, 0)
    if schemes is None:
        schemes = fig2.make_schemes(task, dep, prm, device=dev)
    params = task.init_params(0, dev)
    data = tuple(torch.as_tensor(a, device=dev) for a in td.train)
    run = task.run_config(num_rounds=rounds, eval_every=rounds,
                          batch_size=batch)
    etas = [task.eta_for(pc.name, run.eta) for pc in schemes]

    def fleet():
        return run_fleet(task.loss_fn, params, schemes, dep.gains, data,
                         run, None, etas=etas, flat=True, device=dev)
    c = len(schemes)
    grads = make_gradients(task.loss_fn, run)
    cells = {k: v[None].expand((c,) + tuple(v.shape)).clone()
             for k, v in params.items()}
    x, y = data[0].float(), data[1].long()
    gen = torch.Generator(device=dev).manual_seed(0)
    idx = torch.randint(0, x.shape[1], (1, x.shape[0], batch),
                        generator=gen, device=dev)
    cell_seed = torch.zeros(c, dtype=torch.long, device=dev)

    def call():
        return grads(cells, x, y, idx, cell_seed)
    timing = {}
    for det in (True, False):
        torch.backends.cudnn.deterministic = det
        a, b = call()[0], call()[0]
        timing[f"deterministic_{det}"] = {
            "ms": median_ms(call, iters=5, batches=3, warmup=2),
            "repeat_max_abs_diff": max(float((a[k] - b[k]).abs().max())
                                       for k in a)}
    torch.backends.cudnn.deterministic = True
    return fleet, c, f"{task.name}, minibatch {batch}", timing


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


def profile(fleet, rounds: int) -> dict:
    """Run ``fleet()`` (``rounds`` rounds) three times -- warm-up, timed on
    the host clock, under ``torch.profiler`` -- and return the round wall,
    the device time per round summed over every kernel, the busy share,
    kernel launches per round and the 15 kernels that take the most
    device time."""
    first = fleet()
    t0 = time.time()
    second = fleet()
    wall_ms = 1e3 * (time.time() - t0) / rounds
    with profile_ctx(activities=[ProfilerActivity.CPU,
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
    device_ms = sum(us for _, us in by_name.values()) / 1e3 / rounds
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    return {"round_wall_ms": wall_ms, "device_ms_per_round": device_ms,
            "busy_share": device_ms / wall_ms,
            "repeat_max_abs_diff": max(
                float((first.params[k] - second.params[k]).abs().max())
                for k in first.params),
            "launches_per_round": len(kernels) / rounds,
            "top": [{"name": name[:100], "ms_per_round": us / 1e3 / rounds,
                     "launches_per_round": n / rounds}
                    for name, (n, us) in top]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--batch", type=int, default=None,
                    help="minibatch (default: fig2's for the task)")
    ap.add_argument("--task", default="paper_mlp",
                    help="registered fleet workload "
                         f"({'|'.join(tasks.names(runtime='fleet'))})")
    ap.add_argument("--grid", action="store_true",
                    help="profile the 48-cell scenario grid (paper_mlp)")
    a = ap.parse_args(argv)
    dev = resolve_device(None)
    task = tasks.get("paper_mlp" if a.grid else a.task,
                     expect_runtime="fleet")
    batch = fig2.default_batch(task) if a.batch is None else a.batch
    fleet, cells, label, grad_ms = grid_fleet(task, a.rounds, dev) \
        if a.grid else fig2_fleet(task, a.rounds, batch, dev)
    rep = profile(fleet, a.rounds)
    print(f"card {torch.cuda.get_device_name(0)}; {a.rounds} rounds, "
          f"C = {cells} cells, {label}")
    print(f"round wall {rep['round_wall_ms']:.3f} ms; device time "
          f"{rep['device_ms_per_round']:.3f} ms per round; busy share "
          f"{rep['busy_share']:.3f}; {rep['launches_per_round']:.1f} kernel "
          f"launches per round; two runs' params apart by "
          f"{rep['repeat_max_abs_diff']:.3e}")
    if grad_ms is not None:
        print(f"gradients alone, ms per call: {json.dumps(grad_ms)}")
    for row in rep["top"]:
        print(f"  {row['ms_per_round']:8.4f} ms/round  "
              f"{row['launches_per_round']:6.1f} launches/round  "
              f"{row['name']}")
    print(json.dumps({**rep, "gradients_ms": grad_ms}))


if __name__ == "__main__":
    main()
