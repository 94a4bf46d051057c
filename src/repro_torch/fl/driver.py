"""Host driver of the fleet on one GPU, ported from ``repro.fl.driver``.

``run_fleet`` runs a [K scheme x S seed] grid as one fleet: every tensor
carries a leading cell axis C = K * S, the rounds run as a Python loop, and
the evals come on ``engine.chunk_lengths``' cadence.  Each round's random
numbers come from a draws provider (``fl.draws``): by default
``DeviceDraws`` on the run's device, keyed per (seed, round) and broadcast
over the K schemes, as the reference keys them.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch.func import vmap

from repro_torch.device import resolve_device
from repro_torch.fl.draws import DeviceDraws
from repro_torch.fl.engine import FLResult, chunk_lengths, make_round_body


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_fleet(loss_fn: Callable, params: dict, schemes, gains: np.ndarray,
              data: tuple, run, eval_fn: Optional[Callable] = None, *,
              etas=None, seeds: Optional[Sequence[int]] = None,
              flat: bool = True, log: bool = False,
              uplink_dtype: Optional[str] = None,
              fuse_round: Optional[bool] = None, draws=None,
              use_kernel: Optional[bool] = None,
              device=None) -> FLResult:
    """A [K-scheme x S-seed] experiment grid on one device.

    ``schemes``: K power-control schemes; ``params``: the initial parameter
    dict (shared by every cell); ``data``: stacked device shards (x [N, Dn,
    ...], y [N, Dn]) as numpy or tensors; ``etas``: per-scheme step sizes
    [K] (default run.eta); ``seeds``: the seed axis (default (run.seed,)).
    ``eval_fn(params) -> {name: scalar}`` on one cell's params is vmapped
    over the cells.  ``flat``, ``fuse_round`` and ``uplink_dtype`` choose
    the round tail as in the reference; ``draws`` (a provider, t ->
    ``RoundDraws``) replaces the default ``DeviceDraws``; ``use_kernel``
    passes to the kernel dispatch.  ``device=None`` means CUDA and raises
    without it.
    """
    t0 = time.time()
    dev = resolve_device(device)
    schemes = list(schemes)
    names = tuple(pc.name for pc in schemes)
    k = len(names)
    seeds = tuple(int(s) for s in (seeds if seeds is not None
                                   else (run.seed,)))
    s_axis = len(seeds)
    c = k * s_axis
    etas = np.full(k, run.eta, np.float64) if etas is None \
        else np.asarray(etas, np.float64)
    if etas.shape != (k,):
        raise ValueError(f"etas shape {etas.shape} != ({k},)")
    eta_c = torch.as_tensor(np.repeat(etas, s_axis).astype(np.float32),
                            device=dev)
    cell_seed = torch.arange(c, device=dev) % s_axis

    body = make_round_body(loss_fn, run, flat=flat, uplink_dtype=uplink_dtype,
                           fuse_round=fuse_round, use_kernel=use_kernel)
    x_dev = torch.as_tensor(data[0], dtype=torch.float32, device=dev)
    y_dev = torch.as_tensor(data[1], device=dev).long()
    shard_len = int(x_dev.shape[1])
    batch = run.batch_size if 0 < run.batch_size < shard_len else 0
    params_b = {name: torch.as_tensor(v, device=dev)[None]
                .expand((c,) + tuple(v.shape)).clone()
                for name, v in params.items()}
    if draws is None:
        draws = DeviceDraws(seeds, gains,
                            [params[name].numel() for name in sorted(params)],
                            batch, shard_len, dev)
    eval_b = vmap(eval_fn) if eval_fn is not None else None

    metric_rounds, evals, chunk_walls = [], [], []
    t = 0
    with torch.no_grad():
        for length in chunk_lengths(run.num_rounds, run.eval_every,
                                    eval_fn is not None):
            tc = time.time()
            for _ in range(length):
                params_b, metrics = body(schemes, eta_c, params_b, draws(t),
                                         (x_dev, y_dev), cell_seed)
                metric_rounds.append(metrics)
                t += 1
            _sync(dev)
            chunk_walls.append((length, time.time() - tc))
            if eval_b is not None:
                ev = {name: v.reshape(k, s_axis).cpu().numpy()
                      for name, v in eval_b(params_b).items()}
                evals.append((t - 1, ev))
                if log:
                    lead = next(iter(ev))
                    print({"round": t - 1,
                           **{nm: round(float(ev[lead][i, 0]), 4)
                              for i, nm in enumerate(names)}}, flush=True)
    traces = {}
    if metric_rounds:
        traces = {name: torch.stack([m[name] for m in metric_rounds], dim=-1)
                  .reshape(k, s_axis, -1).cpu().numpy()
                  for name in metric_rounds[0]}
    return FLResult(
        params={name: v.reshape((k, s_axis) + tuple(v.shape[1:]))
                for name, v in params_b.items()},
        traces=traces, evals=evals, names=names, seeds=seeds,
        wall=time.time() - t0, chunk_walls=chunk_walls)


def run_fleet_task(task, schemes, gains: np.ndarray, run=None, *,
                   task_data=None, params: Optional[dict] = None,
                   eval_fn: Optional[Callable] = None, etas=None,
                   seed: Optional[int] = None, device=None,
                   **driver_kw) -> FLResult:
    """Task-first fleet entry point: loss, params, data, eval and the run
    config come from ``task`` (``tasks.base.Task``) unless given.  ``seed``
    (default run.seed) feeds both the data build and the param init;
    ``etas`` default to the task's per-scheme step sizes."""
    dev = resolve_device(device)
    run = run if run is not None else task.run_config()
    seed = run.seed if seed is None else seed
    td = task_data if task_data is not None else task.build_data(seed)
    if params is None:
        params = task.init_params(seed, dev)
    if eval_fn is None:
        eval_fn = task.make_eval(td, dev)
    if etas is None:
        etas = [task.eta_for(pc.name, run.eta) for pc in schemes]
    return run_fleet(task.loss_fn, params, schemes, gains, td.train, run,
                     eval_fn, etas=etas, device=dev, **driver_kw)
