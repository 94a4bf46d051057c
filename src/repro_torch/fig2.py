"""Fig.-2 reproduction on the port: test accuracy and global loss vs FL
rounds for all seven schemes, run as ONE fleet on the GPU.

    python -m repro_torch.fig2 [--task paper_mlp] [--rounds 150]
        [--every 10] [--batch 128] [--uplink f32|bf16|int8] [--unfused]
        [--seed 0] [--checkpoint] [--resume] [--max-chunks N]
        [--device cuda]

A port of the fleet branch of ``benchmarks/fig2.py::run``; the workload
comes from the task registry (``repro_torch.tasks``).  The default is the
minibatch / flat mode (``--batch 128``, the reference's ``--bench``
batch), whose rounds go through kernel K1 (or K2 with ``--unfused``);
``--batch 0`` is the paper's full-batch protocol, which aggregates leaf by
leaf.  ``--checkpoint`` saves the fleet at every chunk boundary under the
task's artifact directory, ``--resume`` continues from that checkpoint
(bitwise equal to an uninterrupted run), and ``--max-chunks N`` stops after
N chunks.  Writes ``experiments/fig2_torch/histories_seed<seed>.json``.
"""
from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import numpy as np

from repro_torch import tasks
from repro_torch.core import channel, power_control as pcm
from repro_torch.core.theory import OTAParams
from repro_torch.device import resolve_device
from repro_torch.fl.driver import run_fleet_task
from repro_torch.kernels.ops import UPLINK_DTYPES

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


def artifact_dir(task) -> Path:
    task = _task(task)
    return ROOT / "experiments" / (task.artifact_tag or task.name)


def build_world(task, seed: int = 0):
    """Deployment + OTA design constants + task data.  The deployment is
    seeded independently of the data seed (one wireless world across data
    seeds), as in the reference."""
    wcfg = channel.WirelessConfig(num_devices=task.num_devices, seed=0)
    dep = channel.deploy(wcfg)
    td = task.build_data(seed)
    prm = OTAParams(d=task.param_dim,
                    gmax=float(task.defaults.get("gmax", 10.0)),
                    es=wcfg.energy_per_sample, n0=wcfg.noise_psd,
                    gains=dep.gains, sigma_sq=np.zeros(wcfg.num_devices),
                    eta=0.05, lsmooth=1.0, kappa_sq=4.0)
    return dep, prm, td


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
        schemes=SCHEMES, batch_size: int = BENCH_BATCH, task="paper_mlp",
        uplink_dtype: str = "f32", fuse_round=None, log: bool = False,
        save: bool = True, out_dir=None, checkpoint_path=None,
        resume: bool = False, max_chunks=None, designs=None, fading=None,
        device=None):
    """Histories of every scheme on ``task`` (a registered name or a Task;
    default paper_mlp at full width); returns (histories, FLResult).
    ``batch_size > 0`` runs the flat minibatch mode, 0 the full-batch
    per-leaf mode.  ``checkpoint_path`` / ``resume`` / ``max_chunks`` and
    ``fading`` (a ``core.scenarios`` process on this world's gains) pass
    to the driver.  ``designs``: the schemes already designed for this
    task's world (``make_schemes``), which does not depend on the data
    seed, so a sweep over seeds designs them once."""
    dev = resolve_device(device)
    task = _task(task)
    dep, prm, td = build_world(task, seed)
    run_cfg = task.run_config(num_rounds=num_rounds, eval_every=eval_every,
                              seed=seed, batch_size=batch_size,
                              uplink_dtype=uplink_dtype)
    pcs = designs if designs is not None \
        else make_schemes(task, dep, prm, schemes, device=dev)
    res = run_fleet_task(task, pcs, dep.gains, run_cfg, task_data=td,
                         flat=batch_size > 0, fuse_round=fuse_round,
                         log=log, checkpoint_path=checkpoint_path,
                         resume=resume, max_chunks=max_chunks, fading=fading,
                         device=dev)
    hist = histories(res)
    if save:
        out = Path(out_dir) if out_dir is not None else artifact_dir(task)
        os.makedirs(out, exist_ok=True)
        with open(out / f"histories_seed{seed}.json", "w") as f:
            json.dump(hist, f, indent=1)
    return hist, res


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
    ap.add_argument("--rounds", type=int, default=150)
    ap.add_argument("--every", type=int, default=10)
    ap.add_argument("--batch", type=int, default=BENCH_BATCH)
    ap.add_argument("--uplink", default="f32", choices=UPLINK_DTYPES)
    ap.add_argument("--unfused", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    try:
        task = _task(a.task)
    except (KeyError, ValueError) as e:
        raise SystemExit(str(e))
    ckpt_path = None
    if a.checkpoint or a.resume:
        ckpt_path = str(artifact_dir(task) / f"fleet_seed{a.seed}")
    hist, res = run(num_rounds=a.rounds, eval_every=a.every, seed=a.seed,
                    batch_size=a.batch, task=task, uplink_dtype=a.uplink,
                    fuse_round=False if a.unfused else None, log=True,
                    checkpoint_path=ckpt_path, resume=a.resume,
                    max_chunks=a.max_chunks, device=a.device)
    for name, h in hist.items():
        print(f"{name:>17}: acc {h[-1]['acc']:.4f}  "
              f"global_loss {h[-1]['global_loss']:.4f}")
    first = (f" (first chunk run {res.chunk_walls[0][1]:.2f} s)"
             if res.chunk_walls else " (no chunk left to run)")
    print(f"wall {res.wall:.2f} s{first}")


if __name__ == "__main__":
    main()
