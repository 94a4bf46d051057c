"""The single-run API of an FL experiment, ported from ``repro.fl.server``.

``run_fl`` is a K = S = 1 ``fl.driver.run_fleet`` (the reference's is its
scan engine's ``run_rounds``): one scheme, one seed, the rounds as the
fleet's Python loop, the evals on its chunk cadence.  ``make_round_fn``
is one round of that fleet for a caller who owns the batch, and takes the
round's draws (``fl.draws.RoundDraws``, or ``FadingDraws`` on a fading
process) rather than a key: in the port draws are inputs.

``run_fl_legacy`` keeps the reference's historical host loop: numpy
minibatches from ``np.random.default_rng(run.seed)`` (``_sample_batches``,
the reference's indices bit for bit), copied host -> device every round,
and one ``make_round_fn`` call a round with h and z from ``DeviceDraws``
keyed per (seed, round).  At full batch it is bitwise ``run_fl``; it is
the wall-clock baseline of ``fig2 --bench``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch.func import vmap

from repro_torch.device import resolve_device


@dataclasses.dataclass
class FLRunConfig:
    eta: float = 0.05
    num_rounds: int = 200
    gmax: float = 10.0
    batch_size: int = 0            # 0 = full batch (paper §IV)
    eval_every: int = 10
    seed: int = 0
    clip_to_gmax: bool = True
    uplink_dtype: str = "f32"      # wire precision devices transmit on the
    #                                uplink: f32 | bf16 | int8 (per-device
    #                                symmetric scale); non-f32 requires the
    #                                flat aggregation path.  See
    #                                kernels.ops.quantize_uplink.


class History(list):
    """Eval-cadence history (a list of dicts) with the per-round metric
    traces attached: ``history.traces`` maps a metric name (grad_norm_mean
    / active_devices / noise_scale) to a [num_rounds] array -- every round,
    not just eval rounds."""

    def __init__(self, *args):
        super().__init__(*args)
        self.traces = {}


def make_round_fn(loss_fn: Callable, scheme, gains: np.ndarray,
                  run: FLRunConfig, fading=None) -> Callable:
    """One round of a single run for a caller who owns the batch.

    Default (fading None, the paper's i.i.d. Rayleigh channel):
        (params, stacked_batch, draws) -> (params, metrics)
    with ``draws`` a one-seed-row ``RoundDraws`` (h [1, N], z [1, D],
    idx None, coin [1]).  With ``fading`` (a ``core.scenarios
    .FadingProcess``) the channel comes from the process and its state
    [1, 1, N] is threaded through:
        (params, stacked_batch, draws, fading_state)
            -> (params, metrics, fading_state)
    with ``draws`` a ``FadingDraws``.  ``params`` are one run's leaves
    (no cell axis); ``stacked_batch`` is (x [N, B, ...], y [N, B]) on the
    run's device.  The round is the fleet's round body at C = 1 with the
    per-leaf tail (the reference's default), so a host loop over this
    function and ``run_fl`` execute the same per-round computation.
    (``gains`` is the deployment the draws were made for, kept for the
    reference's signature.)
    """
    from repro_torch.fl.engine import make_round_body
    body = make_round_body(loss_fn, run)
    proc = None if fading is None else fading.as_stack()
    consts = {}

    def step(params, stacked_batch, draws, fstate):
        dev = stacked_batch[0].device
        if dev not in consts:
            consts[dev] = (torch.full((1,), run.eta, dtype=torch.float32,
                                      device=dev),
                           torch.zeros(1, dtype=torch.int64, device=dev))
        eta, cell_seed = consts[dev]
        out, fstate, metrics = body(
            [scheme], eta, {k: v[None] for k, v in params.items()}, fstate,
            draws, stacked_batch, cell_seed, proc)
        return ({k: v[0] for k, v in out.items()},
                {k: v[0] for k, v in metrics.items()}, fstate)

    if fading is None:
        def round_fn(params, stacked_batch, draws):
            params, metrics, _ = step(params, stacked_batch, draws, None)
            return params, metrics
        return round_fn

    def round_fn(params, stacked_batch, draws, fading_state):
        return step(params, stacked_batch, draws, fading_state)
    return round_fn


def _history_from_result(res, scheme_name: str, t0: float) -> History:
    hist = History()
    active = res.traces.get("active_devices")
    for t, ev in res.evals:
        row = {k: float(np.asarray(v)[0, 0]) for k, v in ev.items()}
        row.update(round=t, scheme=scheme_name,
                   active=float(active[0, 0, t]), wall=time.time() - t0)
        hist.append(row)
    hist.traces = {k: v[0, 0] for k, v in res.traces.items()}
    return hist


def run_fl(loss_fn: Callable, params: dict, scheme, gains: np.ndarray,
           data: tuple, run: FLRunConfig,
           eval_fn: Optional[Callable] = None, log: bool = False,
           fading=None, flat: bool = False, device=None, **fleet_kw):
    """Run the full FL loop of one scheme and one seed (``run.seed``).

    data = (x_dev [N, Dn, ...], y_dev [N, Dn]) stacked per-device datasets.
    eval_fn(params) -> dict of scalars, called at the eval cadence
    (t % run.eval_every == 0 and the last round).  fading: an optional
    ``core.scenarios.FadingProcess`` drawing the per-round channel (None =
    the paper's i.i.d. Rayleigh on ``gains``).  flat: the flat round tail
    (fused: kernel K1 on the card) in place of the per-leaf one.  With
    0 < batch_size < Dn the minibatches come from the draws (per (seed,
    round), on the run's device).  ``fleet_kw`` (``draws``,
    ``use_kernel``, ``uplink_dtype``, ``fuse_round``, ...) passes to
    ``run_fleet``; ``device=None`` means CUDA and raises without it.

    This is a K = S = 1 ``run_fleet``, bitwise its one cell.  Returns
    (params, history): history is the eval-cadence list of dicts with the
    per-round traces as ``history.traces``.
    """
    from repro_torch.fl.driver import run_fleet
    t0 = time.time()
    res = run_fleet(loss_fn, params, [scheme], gains, data, run, eval_fn,
                    seeds=(run.seed,), flat=flat, log=log, fading=fading,
                    device=device, **fleet_kw)
    return ({k: v[0, 0] for k, v in res.params.items()},
            _history_from_result(res, scheme.name, t0))


def run_fl_task(task, scheme, gains: np.ndarray, run=None, *,
                task_data=None, params: Optional[dict] = None,
                eval_fn: Optional[Callable] = None,
                seed: Optional[int] = None, device=None, **kw):
    """Task-first single run: loss, params, data and eval come from
    ``task`` (``tasks.base.Task``) unless given; run = task.run_config()
    and seed = run.seed (feeding both the data and the init) by default,
    as ``fl.driver.run_fleet_task``.  Returns (params, history) like
    :func:`run_fl`."""
    dev = resolve_device(device)
    run = run if run is not None else task.run_config()
    seed = run.seed if seed is None else seed
    td = task_data if task_data is not None else task.build_data(seed)
    if params is None:
        params = task.init_params(seed, dev)
    if eval_fn is None:
        eval_fn = task.make_eval(td, dev)
    return run_fl(task.loss_fn, params, scheme, gains, td.train, run,
                  eval_fn, device=dev, **kw)


# ---------------------------------------------------------------------------
# The historical host loop, kept as the benchmark baseline.
# ---------------------------------------------------------------------------

def _sample_batches(x_dev, y_dev, batch_size: int, rng: np.random.Generator):
    if batch_size <= 0 or batch_size >= x_dev.shape[1]:
        return x_dev, y_dev
    n, d = x_dev.shape[0], x_dev.shape[1]
    idx = rng.integers(0, d, size=(n, batch_size))
    xb = np.take_along_axis(x_dev, idx[..., None], axis=1)
    yb = np.take_along_axis(y_dev, idx, axis=1)
    return xb, yb


def run_fl_legacy(loss_fn: Callable, params: dict, scheme,
                  gains: np.ndarray, data: tuple, run: FLRunConfig,
                  eval_fn: Optional[Callable] = None, log: bool = False,
                  fading=None, device=None):
    """The pre-engine host loop: one round call per round, numpy batch
    sampling (``np.random.default_rng(run.seed)``, the reference's
    indices), a host -> device batch copy every round.  The channel and
    noise come from ``DeviceDraws`` keyed per (seed, round), so at full
    batch this is bitwise ``run_fl``.  The wall-clock baseline of
    ``fig2 --bench``.

    Returns (params, history list of dicts).
    """
    from repro_torch.fl.draws import DeviceDraws
    dev = resolve_device(device)
    round_fn = make_round_fn(loss_fn, scheme, gains, run, fading=fading)
    x_dev, y_dev = (np.asarray(a.detach().cpu().numpy()
                               if isinstance(a, torch.Tensor) else a)
                    for a in data)
    rng = np.random.default_rng(run.seed)
    params = {k: torch.as_tensor(v, device=dev).clone()
              for k, v in params.items()}
    proc = None if fading is None else fading.as_stack()
    draws = DeviceDraws((run.seed,), gains,
                        [params[k].numel() for k in sorted(params)], 0,
                        int(x_dev.shape[1]), dev, fading=proc)
    fading_state = None if proc is None else proc.init_grid(draws.init())
    eval_b = None if eval_fn is None else vmap(eval_fn)
    history = []
    t0 = time.time()
    with torch.no_grad():
        for t in range(run.num_rounds):
            xb, yb = _sample_batches(x_dev, y_dev, run.batch_size, rng)
            batch = (torch.as_tensor(xb, dtype=torch.float32, device=dev),
                     torch.as_tensor(yb, device=dev).long())
            if fading is None:
                params, metrics = round_fn(params, batch, draws(t))
            else:
                params, metrics, fading_state = round_fn(
                    params, batch, draws(t), fading_state)
            if eval_b is not None and (t % run.eval_every == 0
                                       or t == run.num_rounds - 1):
                # the fleet's eval, vmapped over one cell
                ev = {k: float(v[0]) for k, v in
                      eval_b({k: v[None] for k, v in params.items()}).items()}
                ev.update(round=t, scheme=scheme.name,
                          active=float(metrics["active_devices"]),
                          wall=time.time() - t0)
                history.append(ev)
                if log:
                    print({k: (round(v, 4) if isinstance(v, float) else v)
                           for k, v in ev.items()}, flush=True)
    return params, history
