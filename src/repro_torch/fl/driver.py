"""Host driver of the fleet on one GPU, ported from ``repro.fl.driver``.

``run_fleet`` runs a [K scheme x S seed] grid as one fleet: every tensor
carries a leading cell axis C = K * S, the rounds run as a Python loop, and
the evals come on ``engine.chunk_lengths``' cadence.  Each round's random
numbers come from a draws provider (``fl.draws``): by default
``DeviceDraws`` on the run's device, keyed per (seed, round) and broadcast
over the K schemes, as the reference keys them.

The channel is i.i.d. Rayleigh on ``gains`` by default; ``fading`` (a
``core.scenarios.FadingProcess``) makes it a scenario's process, whose
state [1, S, N] the rounds carry; ``scenarios`` (a ``ScenarioStack`` of R
deployments) makes the fleet the [R x K x S] grid, cell (r, k, s) bitwise
the (k, s) cell of a fleet on scenario r alone.  Adaptive schemes
(``AdaptiveSCA``) are re-designed between chunks from the live fading
state, and the chunks then end at the eval cadence.

With ``checkpoint_path`` the fleet is saved at every chunk boundary
(``checkpoint.checkpoint``): params, the fading state, an adaptive fleet's
live designs and design trace, the traces and evals so far, the chunk and
round cursors, and an identity of the run.  ``resume=True`` continues
from that checkpoint and ends bitwise equal to an uninterrupted run: the
draws are keyed per (seed, round), so no RNG state needs saving.
``max_chunks`` stops a run (checkpoint saved) after that many chunks.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch.func import vmap

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.device import resolve_device
from repro_torch.fl.draws import DeviceDraws
from repro_torch.fl.engine import FLResult, chunk_lengths, make_round_body


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _digest(*arrays) -> str:
    h = hashlib.sha1()
    for a in arrays:
        a = np.ascontiguousarray(a.detach().cpu().numpy()
                                 if isinstance(a, torch.Tensor)
                                 else np.asarray(a))
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


_DESIGN_FIELDS = ("gamma", "alpha", "p", "thresholds", "noise_over_alpha")


def _scheme_digest(pc) -> str:
    """The scheme's name and design leaves (gamma, alpha, thresholds, ...),
    hashed: a resume against another design is refused.  Hooks (an
    adaptive scheme's redesign) are code, not design, and are left out."""
    leaves = [getattr(pc, f.name) for f in dataclasses.fields(pc)
              if not f.name.startswith("_")
              and not callable(getattr(pc, f.name))]
    return _digest(*[np.asarray(repr(v) if isinstance(v, str) or v is None
                                else v) for v in leaves])


def _fleet_identity(names, seeds, run, etas, flat, fuse_round, uplink_dtype,
                    d, task_name, schemes, gains, data, fading=None,
                    scenarios=None) -> dict:
    """Everything that must match for a resumed run to be bitwise equal to
    the uninterrupted one: the schemes (names and design leaves), seeds,
    etas, the run config, the round tail (``flat``, ``fuse_round``, the
    uplink dtype), the model size D, the task, and the world (gains and
    data, hashed; the fading process's descriptor; a grid's scenario names
    and its stack's digest).  On a grid the gains digest covers the
    stack's [R, N] gains."""
    return {"fading": "none" if fading is None else fading.describe(),
            "scenarios": ("none" if scenarios is None
                          else list(scenarios.names)),
            "scenario_world": ("none" if scenarios is None
                               else scenarios.describe()),
            "names": list(names), "seeds": list(seeds),
            "schemes": [_scheme_digest(pc) for pc in schemes],
            "etas": [float(e) for e in np.asarray(etas)],
            "run": dataclasses.asdict(run),
            "flat": bool(flat), "fuse_round": fuse_round,
            "uplink_dtype": str(uplink_dtype), "d": int(d),
            "task": task_name,
            "gains": _digest(gains if gains is not None
                             else scenarios.gains),
            "data": _digest(*data)}


def _traces(metric_rounds, prior: dict, k: int, s_axis: int) -> dict:
    """The per-round metrics as numpy [K, S, T]: ``prior`` (restored from a
    checkpoint) followed by this invocation's rounds."""
    if not metric_rounds:
        return dict(prior)
    out = {}
    for name in metric_rounds[0]:
        new = torch.stack([m[name] for m in metric_rounds], dim=-1) \
            .reshape(k, s_axis, -1).cpu().numpy()
        out[name] = np.concatenate([prior[name], new], axis=-1) \
            if name in prior else new
    return out


def _save(path, chunks_done, t, params_b, fstate, schemes, designs,
          traces, evals, identity) -> None:
    state = {"params": params_b, "traces": traces}
    if fstate is not None:
        state["fstate"] = fstate
    if designs is not None:
        state["design"] = {str(i): {f: np.asarray(getattr(pc, f))
                                    for f in _DESIGN_FIELDS}
                           for i, pc in enumerate(schemes)}
        state["designs_t"] = np.asarray([tt for tt, _ in designs], np.int64)
        state["designs_g"] = np.stack([g for _, g in designs])
    if evals:
        state["evals_t"] = np.asarray([tt for tt, _ in evals], np.int64)
        state["evals"] = {name: np.stack([ev[name] for _, ev in evals])
                          for name in evals[0][1]}
    ckpt.save(path, state, meta={"chunks_done": chunks_done,
                                 "rounds_done": t, **identity})


def _load(path, params_b, fstate, schemes, adaptive, identity):
    meta = ckpt.load_meta(path)
    mismatch = {key: (meta.get(key), want) for key, want in identity.items()
                if meta.get(key) != want}
    if mismatch:
        raise ValueError(f"checkpoint {path!r} does not match this fleet "
                         f"(saved vs running): {mismatch}")
    flat = ckpt.load_flat(path)
    like = {"params": params_b}
    if fstate is not None:
        like["fstate"] = fstate
    got = ckpt.restore_flat(flat, like)
    params_b, fstate = got["params"], got.get("fstate")
    designs = None
    if adaptive:
        schemes = [dataclasses.replace(
            pc, _f32={}, **{f: flat[f"design/{i}/{f}"]
                            for f in _DESIGN_FIELDS})
            for i, pc in enumerate(schemes)]
        designs = [(int(tt), flat["designs_g"][i])
                   for i, tt in enumerate(flat["designs_t"])]
    traces = {key[len("traces/"):]: v for key, v in flat.items()
              if key.startswith("traces/")}
    evals = []
    if "evals_t" in flat:
        ev_names = [key[len("evals/"):] for key in flat
                    if key.startswith("evals/")]
        evals = [(int(tt), {nm: flat[f"evals/{nm}"][i] for nm in ev_names})
                 for i, tt in enumerate(flat["evals_t"])]
    return (int(meta["chunks_done"]), int(meta["rounds_done"]), params_b,
            fstate, schemes, designs, traces, evals)


def _scheme_n(pc) -> int:
    return int(np.asarray(pc.p).shape[-1])


def _redesign(schemes, fading, fstate, s_axis):
    """Every adaptive scheme re-designed from the live state: ONE batched
    solve over the K * S rows (the state of the seed rows, tiled over the
    K schemes, as the reference's [K, S] carry holds it), through the
    first scheme's hook.  Returns the schemes and the gamma [K, S, N]."""
    k = len(schemes)
    state = fstate[0].expand((k,) + tuple(fstate.shape[1:]))
    new = schemes[0].redesign_fn(schemes[0], fading, state)
    if new is not schemes[0]:
        schemes = [dataclasses.replace(
            pc, _f32={}, **{f: np.asarray(getattr(new, f))[i]
                            for f in _DESIGN_FIELDS})
            for i, pc in enumerate(schemes)]
    return schemes, _gammas(schemes, s_axis)


def _gammas(schemes, s_axis) -> np.ndarray:
    return np.stack([np.broadcast_to(np.asarray(pc.gamma, np.float64),
                                     (s_axis, _scheme_n(pc)))
                     for pc in schemes])


def run_fleet(loss_fn: Callable, params: dict, schemes, gains: np.ndarray,
              data: tuple, run, eval_fn: Optional[Callable] = None, *,
              etas=None, seeds: Optional[Sequence[int]] = None,
              flat: bool = True, log: bool = False,
              uplink_dtype: Optional[str] = None,
              fuse_round: Optional[bool] = None, draws=None,
              use_kernel: Optional[bool] = None,
              checkpoint_path: Optional[str] = None, resume: bool = False,
              max_chunks: Optional[int] = None,
              task_name: Optional[str] = None, fading=None, scenarios=None,
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

    checkpoint_path  save the fleet at every chunk boundary (an npz; see
                     the module docstring).
    resume           continue from ``checkpoint_path`` if it exists: the
                     chunks it holds are skipped, and the result is
                     bitwise equal to an uninterrupted run's.  A
                     checkpoint of another run (its identity differs:
                     schemes, seeds, etas, run config, round tail, D, task,
                     world) raises a ValueError.
    max_chunks       stop, with the checkpoint saved, after this many
                     chunks of this invocation.
    task_name        joins the checkpoint's identity (``run_fleet_task``
                     passes the task's name).
    fading           a ``core.scenarios.FadingProcess``: the channel of
                     every round (its state is carried and checkpointed);
                     adaptive schemes re-design on it between chunks.
    scenarios        a ``core.scenarios.ScenarioStack`` of R deployments:
                     the [R x K x S] grid.  ``schemes`` are then the R * K
                     schemes scenario-major (scenario r's at rows r K ..
                     r K + K - 1, each designed against ITS gains);
                     ``gains`` and ``fading`` must be None and no scheme
                     adaptive; ``FLResult.names`` are "scenario/scheme".
    """
    t0 = time.time()
    dev = resolve_device(device)
    schemes = list(schemes)
    names = tuple(pc.name for pc in schemes)
    k = len(names)
    hooks = [getattr(pc, "redesign_fn", None) is not None for pc in schemes]
    if any(hooks) and not all(hooks):
        raise ValueError("adaptive (redesign_fn) schemes re-design between "
                         "chunks and run only with other adaptive schemes")
    if scenarios is not None:
        rows = len(scenarios)
        if fading is not None:
            raise ValueError("scenario grids own the channel process; "
                             "pass fading=None")
        if gains is not None:
            raise ValueError("scenario grids own the gains; pass gains=None")
        if any(hooks):
            raise ValueError("adaptive (redesign_fn) schemes are not "
                             "supported on scenario grids")
        if k % rows:
            raise ValueError(f"{k} schemes don't tile over {rows} scenarios "
                             f"(need a multiple of {rows})")
        if scenarios.num_devices != _scheme_n(schemes[0]):
            raise ValueError(
                f"scenario stack is a {scenarios.num_devices}-device world "
                f"but the schemes are designed for {_scheme_n(schemes[0])}")
        names = tuple(f"{sn}/{nm}" for sn, nm in
                      zip(np.repeat(list(scenarios.names), k // rows), names))
    adaptive = any(hooks) and fading is not None
    proc = scenarios if scenarios is not None \
        else None if fading is None else fading.as_stack()     # R rows
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
                            batch, shard_len, dev, fading=proc)
    fstate = None
    if proc is not None and hasattr(draws, "init"):
        fstate = proc.init_grid(draws.init())                  # [R, S, N]
    eval_b = vmap(eval_fn) if eval_fn is not None else None

    metric_rounds, evals, chunk_walls, prior_traces = [], [], [], {}
    designs = [(0, _gammas(schemes, s_axis))] if adaptive else None
    lengths = chunk_lengths(run.num_rounds, run.eval_every,
                            eval_fn is not None or adaptive)
    identity = None
    if checkpoint_path is not None:
        identity = _fleet_identity(
            names, seeds, run, etas, flat, body.fuse, body.uplink_dtype,
            sum(v.numel() for v in params.values()), task_name, schemes,
            gains, data, fading, scenarios)
    start_chunk, t = 0, 0
    if resume and checkpoint_path is not None \
            and ckpt.exists(checkpoint_path):
        (start_chunk, t, params_b, fstate, schemes, designs, prior_traces,
         evals) = _load(checkpoint_path, params_b, fstate, schemes, adaptive,
                        identity)
        if log:
            print(f"# resumed fleet from {checkpoint_path} at chunk "
                  f"{start_chunk} (round {t})", flush=True)
    with torch.no_grad():
        for ci in range(start_chunk, len(lengths)):
            length = lengths[ci]
            tc = time.time()
            for _ in range(length):
                params_b, fstate, metrics = body(
                    schemes, eta_c, params_b, fstate, draws(t),
                    (x_dev, y_dev), cell_seed, proc)
                metric_rounds.append(metrics)
                t += 1
            _sync(dev)
            chunk_walls.append((length, time.time() - tc))
            if adaptive and t < run.num_rounds:
                schemes, gam = _redesign(schemes, fading, fstate, s_axis)
                designs.append((t, gam))
            if eval_b is not None:
                ev = {name: v.reshape(k, s_axis).cpu().numpy()
                      for name, v in eval_b(params_b).items()}
                evals.append((t - 1, ev))
                if log:
                    lead = next(iter(ev))
                    print({"round": t - 1,
                           **{nm: round(float(ev[lead][i, 0]), 4)
                              for i, nm in enumerate(names)}}, flush=True)
            if checkpoint_path is not None:
                _save(checkpoint_path, ci + 1, t, params_b, fstate, schemes,
                      designs, _traces(metric_rounds, prior_traces, k,
                                       s_axis), evals, identity)
            if max_chunks is not None and ci + 1 - start_chunk >= max_chunks \
                    and ci + 1 < len(lengths):
                break        # stopped on purpose; resume=True continues
    traces = _traces(metric_rounds, prior_traces, k, s_axis)
    return FLResult(
        params={name: v.reshape((k, s_axis) + tuple(v.shape[1:]))
                for name, v in params_b.items()},
        traces=traces, evals=evals, names=names, seeds=seeds,
        wall=time.time() - t0, chunk_walls=chunk_walls, fading_state=fstate,
        designs=designs,
        scenario_names=None if scenarios is None else tuple(scenarios.names))


def run_fleet_task(task, schemes, gains: np.ndarray, run=None, *,
                   task_data=None, params: Optional[dict] = None,
                   eval_fn: Optional[Callable] = None, etas=None,
                   seed: Optional[int] = None, device=None,
                   **driver_kw) -> FLResult:
    """Task-first fleet entry point: loss, params, data, eval and the run
    config come from ``task`` (``tasks.base.Task``) unless given.  ``seed``
    (default run.seed) feeds both the data build and the param init;
    ``etas`` default to the task's per-scheme step sizes.  The rest
    (``fading``, ``scenarios``, ``checkpoint_path``, ``resume``,
    ``max_chunks``, ...) passes to ``run_fleet``."""
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
                     eval_fn, etas=etas, device=dev, task_name=task.name,
                     **driver_kw)
