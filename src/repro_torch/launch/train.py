"""End-to-end OTA-FL training driver, ported from ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \\
        --steps 10
    PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x22b \
        --layers 2 --steps 10
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch deepseek-v3-671b --layers 2 --steps 10
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu

Runs the paper's OTA-FL SGD (``launch.steps.make_train_step``) on the
``token_stream`` LM workload of the task registry: the model bundle, the
non-iid vocab-band client shards and the held-out eval come from the Task.
Without ``--smoke`` the arch runs at full width and depth, in its
configured dtype, on the CUDA card (``--device`` picks another; without a
card it raises unless ``--device cpu`` is given); ``--layers`` cuts the
depth (at full width too: mixtral-8x22b and deepseek-v3-671b fit the
card at 2 layers with their gradients).  An MoE arch's loss adds the
router's load-balance term; deepseek's, its MTP head's cross-entropy.

The world is the reference's: ``WirelessConfig(num_devices=clients,
seed)``, its deployment, ``OTAParams(d=num_params, gmax=10, sigma_sq=0,
eta, lsmooth=1, kappa_sq=4)`` and ``make_power_control(scheme)``, whose
``sca`` runs the port's float64 solver on the run's device, while a
second host thread draws the weights (both are host work: the solver's
small launches, the CPU generator's draw; neither touches the other's
numbers).  ``run(design=...)`` takes a design already made for the run's
world instead (``make_design``, which another process may run while the
card does other work); the run refuses one made for another world.  Each
step's
draws come from a generator on the device keyed per (seed + 1, step)
(``launch.steps.DeviceStepDraws``; the reference keys its steps from
``PRNGKey(seed + 1)``).  The loss is differentiated through the plain
attention and SSD scan; the held-out eval runs under ``torch.no_grad()``
with the kernels on (K3, K4).

Prints the reference's lines and its last text line, ``final_loss=...
first_loss=... held_out_loss=... improved=...``, then one JSON line: the
step time (a host clock between device synchronizations, the first step
left out), tokens per second, the K3 and K4 launches of the training loop
and of the eval, and the card's name and power limit.  ``--checkpoint``
writes the reference's archive in its stacked layout
(``checkpoint.save_lm``).
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import inspect
import json
import statistics
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch import tasks as task_registry
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import power_control as pcm
from repro_torch.core.channel import Deployment, WirelessConfig, deploy
from repro_torch.core.theory import OTAParams
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.serve import card_line
from repro_torch.models.param import param_leaves


@dataclasses.dataclass
class TrainResult:
    task: object
    scheme: object
    gains: np.ndarray
    params: torch.nn.Module
    losses: list
    held_out: float
    stats: dict                  # what the JSON line prints


class TrainDesign(NamedTuple):
    """A power-control design, the world it was made for (its
    ``OTAParams``, which hold the deployment's gains) and the seconds it
    took."""
    prm: OTAParams
    pc: pcm.PowerControl
    seconds: float


def world(clients: int, d: int, eta: float = 0.02,
          seed: int = 0) -> tuple[Deployment, OTAParams]:
    """The reference's train world for a model of ``d`` parameters:
    ``WirelessConfig(num_devices=clients, seed)``, its deployment and
    ``OTAParams(d, gmax=10, sigma_sq=0, eta, lsmooth=1, kappa_sq=4)``."""
    wcfg = WirelessConfig(num_devices=clients, seed=seed)
    dep = deploy(wcfg)
    return dep, OTAParams(d=d, gmax=10.0, es=wcfg.energy_per_sample,
                          n0=wcfg.noise_psd, gains=dep.gains,
                          sigma_sq=np.zeros(clients), eta=eta, lsmooth=1.0,
                          kappa_sq=4.0)


def make_design(scheme: str, clients: int, d: int, eta: float = 0.02,
                seed: int = 0, device: DeviceLike = None) -> TrainDesign:
    """``scheme``'s design of ``world(clients, d, eta, seed)``; ``sca``
    solves on ``device`` (None: the card).  Its inputs need no weights,
    so it can be made before the run, elsewhere."""
    dep, prm = world(clients, d, eta, seed)
    kw = {"device": resolve_device(device)} if scheme == "sca" else {}
    t0 = time.perf_counter()
    pc = pcm.make_power_control(scheme, dep, prm, **kw)
    return TrainDesign(prm, pc, time.perf_counter() - t0)


def same_world(a: OTAParams, b: OTAParams) -> bool:
    """Whether two ``OTAParams`` are one world, field for field (a nested
    dataclass, such as a scenario's fading spec, field for field too)."""
    if dataclasses.is_dataclass(a) and dataclasses.is_dataclass(b):
        return type(a) is type(b) and all(
            same_world(getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def _sync(dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def _launches():
    return flash_attention.launches, ssd_scan.launches


def run(*, task: str = "token_stream", arch: str = "qwen1.5-0.5b",
        scheme: str = "sca", steps: int = 50, seq: int = 128,
        clients: int = 4, per_client_batch: int = 1, eta: float = 0.02,
        smoke: bool = False, d_model: int = 0, n_layers: int = 0,
        log_every: int = 10, checkpoint: str = "", seed: int = 0,
        device: DeviceLike = None,
        design: Optional[TrainDesign] = None) -> TrainResult:
    """Train for ``steps`` steps and evaluate the held-out batch.
    ``design``: ``scheme``'s design of this run's world, made beforehand
    (``make_design``); None designs it here."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        t = task_registry.get(
            task, expect_runtime="steps", arch=arch, smoke=smoke,
            d_model=d_model, n_layers=n_layers, clients=clients,
            per_client_batch=per_client_batch, seq=seq, device=dev)
    except (KeyError, ValueError) as e:
        raise SystemExit(f"{e} (fleet tasks go through "
                         "python -m repro_torch.fig2)")
    bundle, cfg = t.aux["bundle"], t.aux["cfg"]
    print(f"arch={cfg.name} params={bundle.num_params / 1e6:.1f}M "
          f"clients={clients}", flush=True)

    _, prm = world(clients, bundle.num_params, eta, seed)
    if design is None:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            drawn = pool.submit(t.init_params, seed, dev)
            design = make_design(scheme, clients, bundle.num_params, eta,
                                 seed, dev)
            params = drawn.result()
    elif design.pc.name != scheme or not same_world(design.prm, prm):
        raise ValueError(
            f"the given {design.pc.name} design was made for another world "
            f"than this run's {scheme} one: {design.prm} vs {prm}")
    else:
        params = t.init_params(seed, dev)
    pc = design.pc
    if pc.p is not None:
        print("participation p:", np.round(pc.p, 3), flush=True)

    step = steps_lib.make_train_step(bundle, pc, prm.gains,
                                     steps_lib.TrainStepConfig(eta=eta))
    td = t.build_data(seed, steps=steps)
    eval_fn = t.make_eval(td, dev)
    draws = steps_lib.DeviceStepDraws(
        seed + 1, prm.gains,
        {k: v.shape for k, v in param_leaves(params).items()}, dev)
    data = torch.as_tensor(td.train, device=dev).long()

    losses, walls = [], []
    k_train = _launches()
    t_start = _sync(dev)
    for i in range(steps):
        t0 = _sync(dev)
        batch = data[i].reshape(-1, seq + 1)
        params, metrics = step(params, batch, draws(i))
        losses.append(float(metrics["loss"]))
        walls.append(_sync(dev) - t0)
        if i % log_every == 0 or i == steps - 1:
            dt = time.perf_counter() - t_start
            print(f"step {i:4d} loss {losses[-1]:.4f} "
                  f"active {float(metrics['active_clients']):.0f}/"
                  f"{clients} {dt / (i + 1):.2f}s/step", flush=True)
    k_train = tuple(b - a for a, b in zip(k_train, _launches()))

    if checkpoint:
        ckpt.save_lm(checkpoint, cfg, params,
                     meta={"arch": cfg.name, "steps": steps,
                           "scheme": scheme, "final_loss": losses[-1]})
        print("checkpoint saved to", checkpoint, flush=True)
    k_eval = _launches()
    t0 = _sync(dev)
    held_out = float(eval_fn(params)["loss"])
    t_eval = _sync(dev) - t0
    k_eval = tuple(b - a for a, b in zip(k_eval, _launches()))
    print(f"final_loss={losses[-1]:.4f} first_loss={losses[0]:.4f} "
          f"held_out_loss={held_out:.4f} improved={losses[-1] < losses[0]}",
          flush=True)

    timed = walls[1:] or walls
    step_s = statistics.median(timed)
    stats = {
        "arch": cfg.name, "params": bundle.num_params, "device": str(dev),
        "scheme": scheme, "steps": steps, "clients": clients,
        "per_client_batch": per_client_batch, "seq": seq, "eta": eta,
        "param_dtype": str(cfg.param_dtype).removeprefix("torch."),
        "step_ms": 1e3 * step_s,
        "step_ms_mean": 1e3 * statistics.fmean(timed),
        "first_step_ms": 1e3 * walls[0],
        "tokens_per_s": clients * per_client_batch * seq / step_s,
        "eval_ms": 1e3 * t_eval,
        "k3_launches_train": k_train[0], "k4_launches_train": k_train[1],
        "k3_launches_eval": k_eval[0], "k4_launches_eval": k_eval[1],
        "first_loss": losses[0], "final_loss": losses[-1],
        "held_out_loss": held_out, "improved": losses[-1] < losses[0],
        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9
        if dev.type == "cuda" else None,
        "card": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else None,
        "card_line": card_line() if dev.type == "cuda" else None,
    }
    return TrainResult(t, pc, prm.gains, params, losses, held_out, stats)


def parse_args(argv=None) -> dict:
    """``run``'s keywords from the CLI's ``argv``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="token_stream",
                    help="registered LM task (runtime 'steps')")
    ap.add_argument("--arch", default="qwen1.5-0.5b",
                    choices=configs.ARCH_IDS)
    ap.add_argument("--scheme", default="sca", choices=pcm.SCHEMES)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--per-client-batch", type=int, default=1)
    ap.add_argument("--eta", type=float, default=0.02)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--d-model", type=int, default=0,
                    help="override d_model for --smoke")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    a = ap.parse_args(argv)
    return dict(task=a.task, arch=a.arch, scheme=a.scheme, steps=a.steps,
                seq=a.seq, clients=a.clients,
                per_client_batch=a.per_client_batch, eta=a.eta,
                smoke=a.smoke, d_model=a.d_model, n_layers=a.layers,
                log_every=a.log_every, checkpoint=a.checkpoint, seed=a.seed,
                device=a.device)


def design_of(kw: dict, device: DeviceLike = None) -> TrainDesign:
    """``make_design`` of the world that ``run(**kw)`` trains in, solved
    on ``device``; d is the task's parameter count, read from its defs
    (no weight is drawn)."""
    a = {k: p.default for k, p in inspect.signature(run).parameters.items()}
    a.update(kw)
    t = task_registry.get(
        a["task"], expect_runtime="steps", arch=a["arch"], smoke=a["smoke"],
        d_model=a["d_model"], n_layers=a["n_layers"], clients=a["clients"],
        per_client_batch=a["per_client_batch"], seq=a["seq"], device="cpu")
    return make_design(a["scheme"], a["clients"], t.param_dim, a["eta"],
                       a["seed"], device)


def main(argv=None, *, design: Optional[TrainDesign] = None
         ) -> TrainResult:
    """The CLI; ``design`` (not a flag) goes to ``run``."""
    res = run(**parse_args(argv), design=design)
    print(json.dumps(res.stats), flush=True)
    return res


if __name__ == "__main__":
    main()
