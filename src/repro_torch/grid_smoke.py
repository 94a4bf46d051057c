"""Two-process bring-up smoke of the process-sliced scenario grid, ported
from ``benchmarks/grid_smoke.py``.

    PYTHONPATH=src python -m repro_torch.grid_smoke --launch [--device cpu]

The parent designs the world's schemes once on the host's CPU (the torch
solver's ``sca``, one batched solve per fading family, as the train runs'
designs are made; ``scenario_sweep.design``), picks a free coordinator
port and spawns two worker processes, each of which

  1. joins the cluster through ``distributed.initialize_multiprocess``
     with four local slots (on one card: four slots on it) and checks the
     view: 2 processes, 4 local slots;
  2. runs its ``distributed.process_grid_slice`` of the scenario axis as
     one [C_slice x K x S] grid fleet through ``ShardedPlacement`` on a
     2 x 2 mesh of its slots;
  3. runs the C = 1 canary grid (the same scenario and config in every
     process) and exchanges sha1 digests of the results through the
     store (``kv_put`` / ``kv_get``): equal canary digests show the
     processes compute identical fleets, so their disjoint slices compose
     one deterministic sweep; process 0 checks that the slices cover the
     scenario axis.

The world is the reference's: disk_rayleigh, disk_rician, disk_markov and
disk_dropout; sca and zero_bias; seeds (0, 1); 4 rounds, an eval every 2,
full batch on the flat, fused tail; an MLP of hidden 16 on mnist_like(40).
A worker exits non-zero on any mismatch, and the parent with it; the
parent kills every worker still running ``--timeout`` seconds after it
spawned them (one deadline for all, not one a worker).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SCENARIOS = ("disk_rayleigh", "disk_rician", "disk_markov", "disk_dropout")
SCHEMES = ("sca", "zero_bias")
SEEDS = (0, 1)
NUM_ROUNDS, EVAL_EVERY, HIDDEN, D = 4, 2, 16, 10000
CANARY = SCENARIOS[0]
KV_TIMEOUT = 120.0          # seconds a worker waits for another's record


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def design(names=SCENARIOS) -> dict:
    """The scenarios' worlds and schemes, designed on the host's CPU."""
    from repro_torch import scenario_sweep
    return scenario_sweep.design(names, schemes=SCHEMES, d=D, device="cpu")


def write_designs(path) -> str:
    """``design()`` pickled to ``path``, for ``launch(designs=path)``."""
    with open(path, "wb") as f:
        pickle.dump(design(), f)
    return str(path)


# ---------------------------------------------------------------------------
# worker
# ---------------------------------------------------------------------------

def _world(dev, seed: int = 0):
    import torch
    from repro_torch.data import partition, synthetic
    from repro_torch.fl.server import FLRunConfig
    from repro_torch.models import mlp
    from repro_torch.models.param import init_params
    x, y, xt, yt = synthetic.mnist_like(40, seed=seed)
    data = partition.stack_shards(partition.partition_by_label(
        x, y, 10, seed=seed))
    params0 = init_params(mlp.mlp_defs(hidden=HIDDEN), seed, dev)
    xt_t = torch.as_tensor(xt, device=dev)
    yt_t = torch.as_tensor(yt, device=dev)

    def ev(p):
        return {"acc": mlp.accuracy(p, xt_t, yt_t)}
    run = FLRunConfig(eta=0.05, num_rounds=NUM_ROUNDS, eval_every=EVAL_EVERY,
                      seed=seed, batch_size=0)
    return data, params0, ev, run


def run_grid(world, designed: dict, names, placement, dev):
    """The [len(names) x K x S] grid fleet of ``names`` on ``placement``."""
    from repro_torch.fl.driver import run_fleet
    from repro_torch.models import mlp
    from repro_torch.scenario_sweep import grid_world
    data, params0, ev, run = world
    stack, pcs = grid_world(designed, tuple(names))
    return run_fleet(mlp.mlp_loss, params0, pcs, None, data, run, ev,
                     etas=[run.eta] * len(pcs), seeds=SEEDS, flat=True,
                     scenarios=stack, placement=placement, device=dev)


def digest(res) -> str:
    h = hashlib.sha1()
    for k in sorted(res.params):
        h.update(res.params[k].detach().cpu().numpy().tobytes())
    for k in sorted(res.traces):
        h.update(np.asarray(res.traces[k]).tobytes())
    return h.hexdigest()


def worker(args) -> None:
    from repro_torch import distributed as dist
    from repro_torch.device import resolve_device
    from repro_torch.fl.placement import ShardedPlacement
    from repro_torch.launch.mesh import make_debug_mesh, visible_slots

    nproc, _ = dist.initialize_multiprocess(
        args.coordinator, args.num_processes, args.process_id,
        local_device_count=args.local_devices)
    dev = resolve_device(args.device)
    slots = visible_slots(dev.type)
    me = args.process_id
    print(f"[p{me}] joined: {nproc} processes, {len(slots)} local slots "
          f"on {sorted({str(d) for d in slots})}", flush=True)
    if nproc != args.num_processes or len(slots) != args.local_devices:
        raise SystemExit(f"[p{me}] cluster view wrong: {nproc} processes, "
                         f"{len(slots)} local slots")
    if args.designs:
        with open(args.designs, "rb") as f:
            designed = pickle.load(f)
    else:
        designed = design()
    world = _world(dev)
    placement = ShardedPlacement(make_debug_mesh(2, 2, slots=slots))

    mine = SCENARIOS[dist.process_grid_slice(len(SCENARIOS))]
    res = run_grid(world, designed, mine, placement, dev)
    slice_digest = digest(res)
    dist.kv_put(f"slice/{me}", json.dumps(
        {"scenarios": list(mine), "digest": slice_digest,
         "cells": len(mine) * len(SCHEMES) * len(SEEDS)}))
    print(f"[p{me}] slice {list(mine)} on "
          f"{placement.describe(cells=len(res.names) * len(SEEDS))}: "
          f"{slice_digest[:12]}", flush=True)

    canary = run_grid(world, designed, (CANARY,), placement, dev)
    mine_d = digest(canary)
    if args.corrupt_canary == me:          # the tests' fault injection
        mine_d = hashlib.sha1(mine_d.encode()).hexdigest()
    dist.kv_put(f"canary/{me}", mine_d)
    for j in range(nproc):
        theirs = dist.kv_get(f"canary/{j}", timeout_s=KV_TIMEOUT)
        if theirs != mine_d:
            raise SystemExit(f"[p{me}] canary digest mismatch vs p{j}: "
                             f"{mine_d[:12]} != {theirs[:12]}")
    print(f"[p{me}] canary bitwise across {nproc} processes: "
          f"{mine_d[:12]}", flush=True)

    if me == 0:       # gather the slice records: the composed sweep
        slices = [json.loads(dist.kv_get(f"slice/{j}", timeout_s=KV_TIMEOUT))
                  for j in range(nproc)]
        covered = [s for rec in slices for s in rec["scenarios"]]
        if covered != list(SCENARIOS):
            raise SystemExit(f"[p0] slices {covered} do not compose the "
                             f"scenario axis {list(SCENARIOS)}")
        print(f"[p0] {len(SCENARIOS)} scenarios covered by {nproc} "
              f"disjoint process slices; "
              f"{sum(r['cells'] for r in slices)} cells total", flush=True)
    # the store lives in process 0: it leaves only after every process
    # has read what it needs from it
    dist.kv_put(f"done/{me}", "1")
    if me == 0:
        for j in range(nproc):
            dist.kv_get(f"done/{j}", timeout_s=KV_TIMEOUT)


# ---------------------------------------------------------------------------
# parent
# ---------------------------------------------------------------------------

def launch(num_processes: int = 2, local_devices: int = 4,
           timeout_s: float = 600.0, device=None, designs=None,
           corrupt_canary=None) -> int:
    """Design (or take ``designs``, a ``write_designs`` pickle), spawn
    the workers, wait, print their lines; returns the first non-zero exit
    code (0 when every worker passed).  ``timeout_s`` bounds the wait for
    all the workers together."""
    tmp = tempfile.mkdtemp(prefix="grid_smoke_")
    procs = []
    try:
        path = designs or write_designs(os.path.join(tmp, "designs.pkl"))
        port = _free_port()
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "")
                                   .split(os.pathsep) if p])
        # each worker sets its own slot count; the parent's would leak in
        env.pop("REPRO_TORCH_DEVICE_SLOTS", None)
        for i in range(num_processes):
            cmd = [sys.executable, "-m", "repro_torch.grid_smoke",
                   "--coordinator", f"127.0.0.1:{port}",
                   "--num-processes", str(num_processes),
                   "--process-id", str(i),
                   "--local-devices", str(local_devices),
                   "--designs", path]
            if device is not None:
                cmd += ["--device", str(device)]
            if corrupt_canary is not None:
                cmd += ["--corrupt-canary", str(corrupt_canary)]
            procs.append(subprocess.Popen(cmd, cwd=str(ROOT), env=env,
                                          stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
        deadline = time.monotonic() + timeout_s
        rc = 0
        for i, p in enumerate(procs):
            try:
                out, _ = p.communicate(
                    timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                out += f"\n[p{i}] TIMEOUT after {timeout_s} s\n"
                rc = rc or 1
            sys.stdout.write(out)
            rc = rc or p.returncode
        return rc
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--launch", action="store_true",
                    help="design, spawn the workers and wait")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT")
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument("--designs", default=None,
                    help="the designs, a write_designs pickle (made here "
                         "when not given)")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--corrupt-canary", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    if args.launch:
        rc = launch(args.num_processes, args.local_devices, args.timeout,
                    args.device, args.designs, args.corrupt_canary)
        if rc:
            raise SystemExit(f"grid smoke FAILED (rc={rc})")
        print(f"grid smoke OK: {args.num_processes} processes x "
              f"{args.local_devices} slots, process-sliced scenario grid + "
              "bitwise canary", flush=True)
        return
    if args.coordinator is None or args.process_id is None:
        raise SystemExit("worker mode needs --coordinator and "
                         "--process-id (or pass --launch)")
    worker(args)


if __name__ == "__main__":
    main()
