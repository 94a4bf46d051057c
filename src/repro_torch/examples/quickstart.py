"""Quickstart on the port: a registered FL workload over a simulated
heterogeneous wireless network (``examples/quickstart.py``).

    python -m repro_torch.examples.quickstart [--task paper_mlp|cifar_conv]
        [--device D]

Trains a task from the workload registry (``repro_torch.tasks``) with
three OTA power-control schemes -- noiseless FedAvg, the paper's SCA
design and the weakest-channel inversion baseline -- as ONE fleet through
``fl.driver.run_fleet_task``: the round tail is kernel K1 on the card,
once a round for the whole fleet.  Then the same fleet over a [scheme x
seed] grid, seeds (0, 1), through the placement layer (``fl.placement``):
vmapped on one device, or, where four or more slots are visible (several
GPUs, or ``REPRO_TORCH_DEVICE_SLOTS=4`` slots on one), its cells sharded
over the ("data", "model") debug mesh -- the script is the same either
way.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import tasks
from repro_torch.core import channel, power_control as pcm
from repro_torch.core.theory import OTAParams

# demo scale per task (the reference's); cifar_conv is cut to demo size,
# its full size runs through ``python -m repro_torch.fig2 --task cifar_conv``
DEMO = {
    "paper_mlp": dict(overrides={}, rounds=60, every=20, batch=64),
    "cifar_conv": dict(overrides=dict(channels=(8, 16), hidden=64,
                                      samples_per_class=150),
                       rounds=12, every=4, batch=32),
}
OTHER = dict(overrides={}, rounds=30, every=10, batch=32)
NAMES = ("ideal", "sca", "vanilla")
GRID_SEEDS = (0, 1)


def world(task, eta: float = 0.05):
    """(deployment, OTAParams): the log-distance, Rayleigh world of the
    task's devices and the Theorem-1 constants of the design."""
    wcfg = channel.WirelessConfig(num_devices=task.num_devices, seed=0)
    dep = channel.deploy(wcfg)
    prm = OTAParams(d=task.param_dim, gmax=task.defaults["gmax"],
                    es=wcfg.energy_per_sample, n0=wcfg.noise_psd,
                    gains=dep.gains, sigma_sq=np.zeros(task.num_devices),
                    eta=eta, lsmooth=1.0, kappa_sq=4.0)
    return dep, prm


def schemes(dep, prm, device=None, names=NAMES) -> list:
    """The three schemes, designed at ``prm.eta``; ``sca`` on ``device``."""
    return [pcm.make_power_control(
        n, dep, prm, **({"device": device} if n == "sca" else {}))
        for n in names]


def design(task_name: str = "paper_mlp", device=None):
    """The three schemes of ``task_name``'s demo world, made where the
    caller likes (``sca`` on ``device``): a ``run.Made`` that ``main``
    takes as ``designs``."""
    import time
    from repro_torch.run import Made
    task = tasks.get(task_name, expect_runtime="fleet",
                     **DEMO.get(task_name, OTHER)["overrides"])
    dep, prm = world(task)
    t0 = time.time()
    pcs = schemes(dep, prm, device)
    return Made((prm,), pcs, time.time() - t0)


def train(task, pcs, dep, run_cfg, td, device=None, seeds=None,
          placement=None):
    """One fleet of the schemes (and ``seeds``), trained at the design's
    step size (the schemes were designed at ``run_cfg.eta``), through
    ``placement`` (None: vmapped on ``device``)."""
    from repro_torch.fl.driver import run_fleet_task
    kw = {} if seeds is None else {"seeds": seeds}
    return run_fleet_task(task, pcs, dep.gains, run_cfg, task_data=td,
                          etas=[run_cfg.eta] * len(pcs), flat=True,
                          placement=placement, device=device, **kw)


def main(argv=None, *, designs=None) -> dict:
    """The CLI.  ``designs`` (not a flag): a ``run.Made`` of the three
    schemes made ahead for this world, checked against it.  Returns the
    two fleets' results."""
    from repro_torch.device import resolve_device
    from repro_torch.launch.train import same_world
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--task", default="paper_mlp",
                    help="registered fleet workload "
                         f"({'|'.join(tasks.names(runtime='fleet'))})")
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    demo = DEMO.get(a.task, OTHER)
    try:
        task = tasks.get(a.task, expect_runtime="fleet", **demo["overrides"])
    except (KeyError, ValueError) as e:
        raise SystemExit(str(e))

    # 1. the workload: data, non-iid partition, model and eval, by name
    td = task.build_data(seed=0)
    print(f"task {task.name}: d={task.param_dim} params, "
          f"{task.num_devices} devices, shard length {td.train[1].shape[1]}")
    # 2. the wireless world; 3. the design's constants
    dep, prm = world(task)
    print("device distances (m):", np.round(dep.distances, 0))
    # 4. three schemes, one fleet
    if designs is not None:
        if not same_world(designs.prms[0], prm):
            raise ValueError("the quickstart designs handed in were made "
                             "for another world")
        pcs = designs.value
    else:
        pcs = schemes(dep, prm, dev)
    run_cfg = task.run_config(num_rounds=demo["rounds"],
                              eval_every=demo["every"],
                              batch_size=demo["batch"])
    res = train(task, pcs, dep, run_cfg, td, dev)
    for i, pc in enumerate(pcs):
        traj = " -> ".join(f"{float(ev['acc'][i, 0]):.3f}"
                           for _, ev in res.evals)
        print(f"{pc.name:8s} acc: {traj}")
    print(f"one fleet, wall {res.wall:.1f}s; per-round traces: "
          f"{sorted(res.traces)} shape {res.traces['active_devices'].shape}")
    # 5. the SAME fleet through the placement layer: vmapped on one
    #    device, or with >= 4 slots (several GPUs, or
    #    REPRO_TORCH_DEVICE_SLOTS=4 on one) the [scheme x seed] cells
    #    sharded over the ("data", "model") mesh -- the script is
    #    unchanged either way
    from repro_torch.fl.placement import ShardedPlacement, VmapPlacement
    from repro_torch.launch.mesh import make_debug_mesh, visible_slots
    slots = visible_slots(dev.type)
    if len(slots) >= 4:
        placement = ShardedPlacement(make_debug_mesh(2, 2, slots=slots))
        where = f"sharded over {placement.num_devices} devices"
    else:
        placement = VmapPlacement()
        where = "vmapped on 1 device"
    res2 = train(task, pcs, dep, run_cfg, td, dev, seeds=GRID_SEEDS,
                 placement=placement)
    final = res2.evals[-1][1]["acc"]
    print(f"[scheme x seed] grid {where}: final acc per cell "
          f"{np.round(np.asarray(final), 3).tolist()}")
    return {"fleet": res, "grid": res2}


if __name__ == "__main__":
    main()
