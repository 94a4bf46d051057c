"""Where a full-width fleet round's time goes, on the card.

    python -m repro_torch.profile_round [--rounds 20] [--batch 128]

Runs the Fig.-2 fleet's main path (paper_mlp at full width, 7 schemes,
S = 1, minibatch, flat, fused, f32 uplink, no evals) three times: once to
warm up, once timed on the host clock (the driver synchronizes the device
at the end), once under ``torch.profiler``.  Prints the round wall, the
device time per round summed over every kernel the profiler saw, the
device's busy share (device time over the unprofiled wall: one stream, so
kernels do not overlap), kernel launches per round, and the kernels that
take the most device time.  The last line is one JSON object with those
numbers.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import fig2
from repro_torch.device import resolve_device
from repro_torch.fl.driver import run_fleet
from repro_torch.tasks.image import make_paper_mlp


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--batch", type=int, default=fig2.BENCH_BATCH)
    a = ap.parse_args(argv)
    dev = resolve_device(None)
    task = make_paper_mlp()
    dep, prm, td = fig2.build_world(task, 0)
    schemes = fig2.make_schemes(task, dep, prm)
    params = task.init_params(0, dev)
    run = task.run_config(num_rounds=a.rounds, eval_every=a.rounds,
                          batch_size=a.batch)
    etas = [task.eta_for(pc.name, run.eta) for pc in schemes]

    def fleet():
        return run_fleet(task.loss_fn, params, schemes, dep.gains, td.train,
                         run, None, etas=etas, flat=True, device=dev)

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
          f"C = {len(schemes)} cells, minibatch {a.batch}")
    print(f"round wall {wall_ms:.3f} ms; device time {device_ms:.3f} ms per "
          f"round; busy share {device_ms / wall_ms:.3f}; "
          f"{len(kernels) / a.rounds:.1f} kernel launches per round")
    for name, (n, us) in top:
        print(f"  {us / 1e3 / a.rounds:8.4f} ms/round  {n / a.rounds:6.1f}"
              f" launches/round  {name[:100]}")
    print(json.dumps({
        "round_wall_ms": wall_ms, "device_ms_per_round": device_ms,
        "busy_share": device_ms / wall_ms,
        "launches_per_round": len(kernels) / a.rounds,
        "top": [{"name": name[:100], "ms_per_round": us / 1e3 / a.rounds,
                 "launches_per_round": n / a.rounds}
                for name, (n, us) in top]}))


if __name__ == "__main__":
    main()
