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

Population mode: pass a ``core.scenarios.Population`` and each chunk runs
on a drawn cohort of ``cohort_size`` devices out of up to ~1M, with the
draw, the gains and ``adaptive_sca``'s cohort redesign staged on the host
WHILE the previous chunk runs on the card (double-buffered; ``stream=False``
serializes the same stages -- identical numbers, different walls).
Staging is pure in (population, run seed, tick), never in chunk outputs,
which is why overlap cannot change results and why resume needs no RNG
cursor.  The staging lane is one host thread: numpy and the CPU f64
solver, nothing on the card (work it enqueued on the default stream would
wait behind the chunk); the chunk's small cohort operands go to the card
from the main thread when the chunk starts.  A Gauss-Markov population
carries each device's state across cohorts in a host re-entry table
(``Population.stage_states`` before a chunk, ``commit_states`` after).

Telemetry (``telemetry=``): the reference's event log at the reference's
points -- ``run_start`` / ``run_resume``, ``fleet_config``, ``stage``,
``stage_wait`` and ``cohort`` in population mode, ``chunk_exec`` per chunk,
the ``redesign``, ``eval`` and ``ckpt_save`` spans, the solver's
``sca_solve`` on the redesign paths (tagged with their chunk, from the
staging thread too), ``run_end`` -- and the per-round ``bv_*`` traces.
The port runs eagerly and emits no ``chunk_compile``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.func import vmap

from repro_torch import telemetry as tlm
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import ota
from repro_torch.device import resolve_device
from repro_torch.fl.draws import DeviceDraws
from repro_torch.fl.engine import FLResult, chunk_lengths, make_round_body
from repro_torch.solvers import sca as sca_solver


# the reference's run_fleet keywords whose modules are not ported yet
NOT_PORTED = {"placement": "ROADMAP.md §1, module 12 (multi-device "
                           "placement)"}


class _Staged(NamedTuple):
    """One staged cohort: everything chunk ``ci`` needs that can be
    computed before chunk ``ci - 1`` finishes (the double buffer); host
    arrays only."""
    ci: int
    tick: int
    idx: np.ndarray      # [S, N] drawn device indices (per seed row)
    gains: np.ndarray    # [S, N] their average gains
    design: object       # the cohort-redesigned scheme (None if none)
    wall: float


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
                    scenarios=None, population=None, cohort_size=None,
                    cohort_rounds=None) -> dict:
    """Everything that must match for a resumed run to be bitwise equal to
    the uninterrupted one: the schemes (names and design leaves), seeds,
    etas, the run config, the round tail (``flat``, ``fuse_round``, the
    uplink dtype), the model size D, the task, and the world (gains and
    data, hashed; the fading process's descriptor; a grid's scenario names
    and its stack's digest; the population's descriptor and the cohort
    schedule).  On a grid the gains digest covers the stack's [R, N]
    gains.  ``stream`` is not identity: overlap changes walls, never
    numbers."""
    return {"population": ("none" if population is None
                           else population.describe()),
            "cohort_size": int(cohort_size or 0),
            "cohort_rounds": int(cohort_rounds or 0),
            "fading": "none" if fading is None else fading.describe(),
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
          traces, evals, identity, pop_table=None, cohorts=None) -> None:
    state = {"params": params_b, "traces": traces}
    if fstate is not None:
        state["fstate"] = fstate
    if designs:
        state["design"] = {str(i): {f: np.asarray(getattr(pc, f))
                                    for f in _DESIGN_FIELDS}
                           for i, pc in enumerate(schemes)}
        state["designs_t"] = np.asarray([tt for tt, _ in designs], np.int64)
        state["designs_g"] = np.stack([g for _, g in designs])
    if evals:
        state["evals_t"] = np.asarray([tt for tt, _ in evals], np.int64)
        state["evals"] = {name: np.stack([ev[name] for _, ev in evals])
                          for name in evals[0][1]}
    if pop_table is not None:
        # the population cursor: which devices the stream has seen, and
        # their Gauss-Markov states (cohort draws re-derive from the tick)
        state["pop_last"] = pop_table["last"]
        state["pop_state"] = pop_table["state"]
    if cohorts:
        state["cohorts_t"] = np.asarray([tt for tt, _ in cohorts], np.int64)
        state["cohorts_idx"] = np.stack([i for _, i in cohorts])
    ckpt.save(path, state, meta={"chunks_done": chunks_done,
                                 "rounds_done": t, **identity})


def _load(path, params_b, fstate, schemes, adaptive, identity,
          pop_table=None):
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
        designs = []
        if "designs_t" in flat:
            schemes = [dataclasses.replace(
                pc, _f32={}, **{f: flat[f"design/{i}/{f}"]
                                for f in _DESIGN_FIELDS})
                for i, pc in enumerate(schemes)]
            designs = [(int(tt), flat["designs_g"][i])
                       for i, tt in enumerate(flat["designs_t"])]
    if pop_table is not None and "pop_last" in flat:
        pop_table["last"][...] = flat["pop_last"]
        pop_table["state"][...] = flat["pop_state"]
    cohorts = None
    if "cohorts_t" in flat:
        cohorts = [(int(tt), np.asarray(flat["cohorts_idx"][i]))
                   for i, tt in enumerate(flat["cohorts_t"])]
    traces = {key[len("traces/"):]: v for key, v in flat.items()
              if key.startswith("traces/")}
    evals = []
    if "evals_t" in flat:
        ev_names = [key[len("evals/"):] for key in flat
                    if key.startswith("evals/")]
        evals = [(int(tt), {nm: flat[f"evals/{nm}"][i] for nm in ev_names})
                 for i, tt in enumerate(flat["evals_t"])]
    return (int(meta["chunks_done"]), int(meta["rounds_done"]), params_b,
            fstate, schemes, designs, traces, evals, cohorts)


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


def _cohort_schemes(schemes, new):
    """The K schemes with the cohort redesign's leaves ([S, N], [S]): one
    solve over the S seed rows serves every scheme, as the first scheme's
    hook serves every row of an adaptive fleet."""
    return [dataclasses.replace(pc, _f32={}, **{f: np.asarray(getattr(new, f))
                                                for f in _DESIGN_FIELDS})
            for pc in schemes]


def _cohort_operands(staged, x_dev, y_dev, batch, fading, dev):
    """The chunk's cohort operands on the card (made in the main thread):
    the data each active device trains on and, on a fading process, the
    cohort's gains, scale and LOS; returns (data, cohort, scale), scale
    being the i.i.d. channel's [S, N] (None on a process)."""
    di = staged.idx % x_dev.shape[0]                          # [S, N]
    shared = bool((di == di[:1]).all())
    cohort = {"data_idx": torch.as_tensor(di, device=dev),
              "per_seed": batch == 0 and not shared, "fade": None}
    data = (x_dev, y_dev)
    if batch == 0:        # full batch: gather once, shared where it can be
        rows = torch.as_tensor(di[0] if shared else di, device=dev)
        data = (x_dev[rows], y_dev[rows])
    scale = None
    if fading is None:
        scale = torch.as_tensor(ota.fading_scales(staged.gains)[0],
                                device=dev)
    else:
        cohort["fade"] = {k: torch.as_tensor(v, device=dev) for k, v in
                          fading.cohort_operands(staged.gains).items()}
    return data, cohort, scale


def _cohort_event(tracer, ci, t_start, staged, pop_table) -> None:
    """The ``cohort`` event of a fresh tick; on a fading process, each
    drawn device's staleness off the re-entry table BEFORE staging touches
    it: rounds since it last took part (-1 = never)."""
    rec = {"chunk": ci, "t": t_start, "tick": staged.tick,
           "cohort_size": int(staged.idx.shape[1])}
    if pop_table is not None:
        seen = np.stack([pop_table["last"][si, staged.idx[si]]
                         for si in range(staged.idx.shape[0])])
        rec["staleness"] = np.where(seen < 0, -1,
                                    np.maximum(t_start - 1 - seen, 0))
        rec["never_seen"] = int(np.sum(seen < 0))
    tracer.event("cohort", **rec)


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
              population=None, cohort_size: Optional[int] = None,
              cohort_rounds: Optional[int] = None, stream: bool = True,
              telemetry=None, placement=None, device=None) -> FLResult:
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
                     world, population and cohort schedule) raises a
                     ValueError.
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
                     Exclusive with ``population``.
    population       a ``core.scenarios.Population``: each chunk runs on a
                     drawn cohort.  Data shards go by device index mod the
                     shard count; the gains come from the population.
                     ``fading`` defaults to the population's own process
                     (``Population.fading_process``).
    cohort_size      active devices per round, default (and necessarily)
                     the schemes' device count.
    cohort_rounds    redraw cadence in rounds; None: once per chunk (the
                     eval cadence).  A cohort never straddles a chunk.
    stream           stage the next cohort (draw, gains, the adaptive
                     cohort redesign) on a host thread while the current
                     chunk runs; False stages the same serially -- bitwise
                     the same results.
    telemetry        a ``telemetry.Telemetry`` (or a bare run-dir string):
                     the event log ``events.jsonl`` in its run dir (the
                     reference's events at the reference's points; a
                     resumed run prunes the log to its completed chunks and
                     keeps the run id) and the ``bv_*`` diagnostic traces.
                     Params, the other traces and the evals are bitwise
                     those of the run without it.
    placement        the reference's multi-device placement: not ported yet
                     (NotImplementedError).
    """
    if placement is not None:
        raise NotImplementedError(
            "run_fleet(placement=...) is not ported yet; see "
            f"{NOT_PORTED['placement']}")
    t0 = time.time()
    dev = resolve_device(device)
    schemes = list(schemes)
    names = tuple(pc.name for pc in schemes)
    k = len(names)
    hooks = [getattr(pc, "redesign_fn", None) is not None for pc in schemes]
    if any(hooks) and not all(hooks):
        raise ValueError("adaptive (redesign_fn) schemes re-design between "
                         "chunks and run only with other adaptive schemes")
    pop_mode = population is not None
    if scenarios is not None:
        rows = len(scenarios)
        if pop_mode:
            raise ValueError("scenario grids and population mode are "
                             "exclusive (a cohort would need per-scenario "
                             "device worlds)")
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
    n_cohort = cadence = None
    if pop_mode:
        n_cohort = int(cohort_size) if cohort_size else _scheme_n(schemes[0])
        if not 0 < n_cohort <= population.size:
            raise ValueError(f"cohort size {n_cohort} not in "
                             f"[1, {population.size}]")
        if _scheme_n(schemes[0]) != n_cohort:
            raise ValueError(
                f"schemes are designed for {_scheme_n(schemes[0])} devices "
                f"but the cohort draws {n_cohort} -- build the power "
                f"control for the cohort-sized world")
        cadence = int(cohort_rounds) if cohort_rounds else None
        if fading is None:
            fading = population.fading_process()
    adaptive = any(hooks) and fading is not None and not pop_mode
    redesign_cohort = getattr(schemes[0], "redesign_cohort_fn", None)
    pop_adaptive = pop_mode and redesign_cohort is not None
    if scenarios is not None:
        proc = scenarios
    elif fading is None:
        proc = None
    else:                                                      # R = 1 row
        proc = fading.cohort_stack(n_cohort) if pop_mode \
            else fading.as_stack()
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

    tel = tlm.Telemetry(run_dir=telemetry) if isinstance(telemetry, str) \
        else telemetry
    resuming = bool(resume and checkpoint_path is not None
                    and ckpt.exists(checkpoint_path))
    # fresh=False keeps the existing log: the resumed process reads the run
    # id back and ``tracer.resume`` prunes the superseded suffix
    tracer = tlm.Tracer(tel.run_dir, fresh=not resuming) \
        if tel is not None and tel.trace else None
    metrics_hook = tlm.make_metrics_hook(tel.kappa_sq) \
        if tel is not None and tel.diagnostics else None

    def span(kind, **fields):
        return tracer.span(kind, **fields) if tracer is not None \
            else contextlib.nullcontext()

    def ctx(**fields):
        return tracer.ctx(**fields) if tracer is not None \
            else contextlib.nullcontext()

    body = make_round_body(loss_fn, run, flat=flat, uplink_dtype=uplink_dtype,
                           fuse_round=fuse_round, use_kernel=use_kernel,
                           metrics_hook=metrics_hook)
    x_dev = torch.as_tensor(data[0], dtype=torch.float32, device=dev)
    y_dev = torch.as_tensor(data[1], device=dev).long()
    shard_len = int(x_dev.shape[1])
    batch = run.batch_size if 0 < run.batch_size < shard_len else 0
    params_b = {name: torch.as_tensor(v, device=dev)[None]
                .expand((c,) + tuple(v.shape)).clone()
                for name, v in params.items()}
    if draws is None:
        draws = DeviceDraws(seeds, np.ones(n_cohort) if pop_mode else gains,
                            [params[name].numel() for name in sorted(params)],
                            batch, shard_len, dev, fading=proc)
    fstate, pop_table = None, None
    if pop_mode:
        if fading is not None:     # states staged per chunk from the table
            pop_table = population.init_table(s_axis)
    elif proc is not None and hasattr(draws, "init"):
        fstate = proc.init_grid(draws.init())                  # [R, S, N]
    eval_b = vmap(eval_fn) if eval_fn is not None else None

    metric_rounds, evals, chunk_walls, prior_traces = [], [], [], {}
    designs = [(0, _gammas(schemes, s_axis))] if adaptive \
        else [] if pop_adaptive else None
    cohorts = [] if pop_mode else None
    lengths = chunk_lengths(run.num_rounds, run.eval_every,
                            eval_fn is not None or adaptive or pop_adaptive,
                            cadence)
    starts = np.concatenate([[0], np.cumsum(lengths)])[:-1].astype(int)

    def tick_of(ci: int) -> int:
        return int(starts[ci]) // cadence if cadence else ci

    def stage(ci: int, base) -> _Staged:
        # pure in (population, seeds, tick) and the schemes' constants,
        # never in chunk outputs: running it beside the chunk (stream)
        # cannot change a number.  Host only: numpy and the CPU solver.
        # The tracer's ctx tags the solver's events (in the staging thread
        # too) with this chunk, which is what lets a resume prune them.
        ts = time.time()
        with ctx(chunk=ci):
            tick = tick_of(ci)
            idx = np.stack([population.draw_cohort(n_cohort, tick, s)
                            for s in seeds])                      # [S, N]
            gains_sn = np.stack([population.gains_of(r) for r in idx])
            new = None
            if pop_adaptive and (ci == 0 or tick != tick_of(ci - 1)):
                new = redesign_cohort(base, gains_sn, device="cpu")
        staged = _Staged(ci, tick, idx, gains_sn, new, time.time() - ts)
        if tracer is not None:
            tracer.event("stage", chunk=ci, tick=tick,
                         dur=round(staged.wall, 6),
                         redesigned=new is not None)
        return staged

    identity = None
    if checkpoint_path is not None:
        identity = _fleet_identity(
            names, seeds, run, etas, flat, body.fuse, body.uplink_dtype,
            sum(v.numel() for v in params.values()), task_name, schemes,
            gains, data, fading, scenarios, population, n_cohort, cadence)
    start_chunk, t = 0, 0
    if resuming:
        (start_chunk, t, params_b, fstate, schemes, designs, prior_traces,
         evals, loaded_cohorts) = _load(checkpoint_path, params_b, fstate,
                                        schemes, adaptive or pop_adaptive,
                                        identity, pop_table)
        if loaded_cohorts is not None:
            cohorts = loaded_cohorts
        if log:
            print(f"# resumed fleet from {checkpoint_path} at chunk "
                  f"{start_chunk} (round {t})", flush=True)
    if tracer is not None:
        if resuming:
            # drop the events of chunks this process re-runs: the log
            # describes ONE execution (no duplicate chunk spans)
            tracer.resume(start_chunk)
        tracer.event("fleet_config", names=list(names), seeds=list(seeds),
                     num_rounds=int(run.num_rounds),
                     eval_every=int(run.eval_every), placement="vmap",
                     chunks=len(lengths),
                     population=(int(population.size) if pop_mode else None),
                     cohort_size=n_cohort, cohort_rounds=cadence,
                     scenarios=(list(scenarios.names) if scenarios is not None
                                else None),
                     stream=bool(stream), start_chunk=start_chunk)
    last_tick = tick_of(start_chunk - 1) if pop_mode and start_chunk > 0 \
        else None
    executor = ThreadPoolExecutor(max_workers=1) if pop_mode and stream \
        else None
    staged = next_fut = None
    stage_walls = [] if pop_mode else None
    wall_compile, first = 0.0, True
    chunks_done = start_chunk
    chunk_data, cohort_op = (x_dev, y_dev), None
    prev_hook = None if tracer is None else sca_solver.set_trace_hook(
        lambda rec: tracer.event("sca_solve", **rec))
    try:
        with torch.no_grad():
            for ci in range(start_chunk, len(lengths)):
                length = lengths[ci]
                if pop_mode:
                    if next_fut is not None:
                        tw = time.monotonic()
                        staged, next_fut = next_fut.result(), None
                        if tracer is not None:
                            # how long the driver sat on the double buffer
                            # (0 when the stage hid behind the last chunk)
                            tracer.event("stage_wait", chunk=staged.ci,
                                         dur=round(time.monotonic() - tw, 6))
                    if staged is None or staged.ci != ci:
                        staged = stage(ci, schemes[0])
                    stage_walls.append(staged.wall)
                    t_start = int(starts[ci])
                    if staged.tick != last_tick:
                        last_tick = staged.tick
                        cohorts.append((t_start, staged.idx))
                        if pop_adaptive:
                            schemes = _cohort_schemes(schemes, staged.design)
                            designs.append((t_start,
                                            _gammas(schemes, s_axis)))
                        if tracer is not None:
                            _cohort_event(tracer, ci, t_start, staged,
                                          pop_table)
                    if fading is not None:
                        # re-entry reads the table the previous chunk
                        # committed, so it stays in the main thread
                        fstate = torch.as_tensor(np.stack([
                            population.stage_states(pop_table, si,
                                                    staged.idx[si], t_start,
                                                    seed=seeds[si])
                            for si in range(s_axis)])[None], device=dev)
                    chunk_data, cohort_op, scale = _cohort_operands(
                        staged, x_dev, y_dev, batch, fading, dev)
                    if scale is not None and hasattr(draws, "set_scale"):
                        draws.set_scale(scale)
                    will_stop = (max_chunks is not None
                                 and ci + 1 - start_chunk >= max_chunks
                                 and ci + 1 < len(lengths))
                    if executor is not None and ci + 1 < len(lengths) \
                            and not will_stop:
                        # the double buffer: stage chunk ci + 1 while
                        # chunk ci runs
                        next_fut = executor.submit(stage, ci + 1, schemes[0])
                tc, t_ex, t_chunk = time.time(), time.monotonic(), t
                for _ in range(length):
                    params_b, fstate, metrics = body(
                        schemes, eta_c, params_b, fstate, draws(t),
                        chunk_data, cell_seed, proc, cohort_op)
                    metric_rounds.append(metrics)
                    t += 1
                _sync(dev)
                chunk_walls.append((length, time.time() - tc))
                if tracer is not None:
                    tracer.event("chunk_exec", chunk=ci, length=int(length),
                                 t_start=t_chunk, cache_size=None,
                                 dur=round(time.monotonic() - t_ex, 6))
                if first:
                    wall_compile, first = time.time() - t0, False
                if pop_table is not None:
                    # scheme rows share the state: commit seed row s's
                    fs = fstate[0].cpu().numpy()
                    for si in range(s_axis):
                        population.commit_states(pop_table, si,
                                                 staged.idx[si], t - 1,
                                                 fs[si])
                if adaptive and t < run.num_rounds:
                    with ctx(chunk=ci), span("redesign", chunk=ci, t=t):
                        schemes, gam = _redesign(schemes, fading, fstate,
                                                 s_axis)
                    designs.append((t, gam))
                if eval_b is not None:
                    with span("eval", chunk=ci, t=t - 1):
                        ev = {name: v.reshape(k, s_axis).cpu().numpy()
                              for name, v in eval_b(params_b).items()}
                    evals.append((t - 1, ev))
                    if log:
                        lead = next(iter(ev))
                        print({"round": t - 1,
                               **{nm: round(float(ev[lead][i, 0]), 4)
                                  for i, nm in enumerate(names)}},
                              flush=True)
                if checkpoint_path is not None:
                    with span("ckpt_save", chunk=ci):
                        _save(checkpoint_path, ci + 1, t, params_b,
                              None if pop_mode else fstate, schemes, designs,
                              _traces(metric_rounds, prior_traces, k,
                                      s_axis),
                              evals, identity, pop_table, cohorts)
                chunks_done = ci + 1
                if max_chunks is not None \
                        and ci + 1 - start_chunk >= max_chunks \
                        and ci + 1 < len(lengths):
                    break    # stopped on purpose; resume=True continues
    finally:
        if tracer is not None:
            sca_solver.set_trace_hook(prev_hook)
        if executor is not None:
            executor.shutdown(wait=True)
    traces = _traces(metric_rounds, prior_traces, k, s_axis)
    wall = time.time() - t0
    wall_stage = float(sum(stage_walls or ()))
    if tracer is not None:
        tracer.event("run_end", rounds_done=int(t), chunks_done=chunks_done,
                     wall_s=round(wall, 3), wall_stage=round(wall_stage, 3))
    return FLResult(
        params={name: v.reshape((k, s_axis) + tuple(v.shape[1:]))
                for name, v in params_b.items()},
        traces=traces, evals=evals, names=names, seeds=seeds,
        wall=wall, chunk_walls=chunk_walls, fading_state=fstate,
        designs=designs,
        scenario_names=None if scenarios is None else tuple(scenarios.names),
        wall_compile=wall_compile, wall_exec=wall - wall_compile,
        wall_stage=wall_stage, cohorts=cohorts,
        stage_walls=stage_walls)


def run_fleet_task(task, schemes, gains: np.ndarray, run=None, *,
                   task_data=None, params: Optional[dict] = None,
                   eval_fn: Optional[Callable] = None, etas=None,
                   seed: Optional[int] = None, device=None,
                   **driver_kw) -> FLResult:
    """Task-first fleet entry point: loss, params, data, eval and the run
    config come from ``task`` (``tasks.base.Task``) unless given.  ``seed``
    (default run.seed) feeds both the data build and the param init;
    ``etas`` default to the task's per-scheme step sizes.  The rest
    (``fading``, ``scenarios``, ``population``, ``checkpoint_path``,
    ``resume``, ``max_chunks``, ...) passes to ``run_fleet``."""
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
