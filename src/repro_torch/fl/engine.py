"""One FL round of the fleet, ported from ``repro.fl.engine``.

The reference compiles its rounds into ``lax.scan`` chunks and vmaps them
over the [K scheme x S seed] grid.  PyTorch runs eagerly, so here the grid
is a leading cell axis C = K * S on every tensor (cell c is scheme c // S,
seed c % S), and ``fl.driver`` runs the rounds as a Python loop.  A
[R scenario x K scheme x S seed] grid is the same fleet over the R * K
schemes listed scenario-major: cell (r, k, s) is cell (r K + k) S + s.  A
round:

  1. per-device gradients over [C, N] (``torch.func.vmap`` of
     ``torch.func.grad``), clipped to G_max; on a scenario grid, one
     scenario's cells at a time, so each scenario's cells run the same
     kernels at the same shapes as that scenario's own fleet (the GEMM
     libraries pick their algorithm by shape; this is what keeps every
     grid cell bitwise the per-scenario fleet's);
  2. the round's fading: h [S, N] from the draws, or one row per scenario
     [R, S, N] from the step of the fleet's ``ScenarioStack`` (a
     ``FadingProcess`` is a stack of R = 1), whose state [R, S, N] the
     round carries; in population mode the round runs on the chunk's
     cohort (``cohort``): its devices' data shards and, on a process, its
     gains, scale and LOS as operands of the step;
  3. every scheme's ``round_coeffs`` on its scenario row's fading (one row
     per seed, shared by the scenario's schemes);
  4. the round tail: fused (kernel K1: uplink, superposition, noise and
     SGD step in one launch over all C cells), or unfused (kernel K2 on the
     flat path, or the per-leaf oracle) followed by the SGD step.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
from torch.func import grad, vmap

from repro_torch.core import ota
from repro_torch.optim.optimizers import clip_by_global_norm


@dataclasses.dataclass
class FLResult:
    """What a fleet run returns.

    params        final parameters, leaves with leading [K, S] axes
    traces        per-round metric traces {name: [K, S, T]} (numpy)
    evals         [(round, {name: [K, S] numpy})] at the eval cadence
    names         scheme names, length K
    seeds         seeds swept, length S
    wall          total wall-clock seconds, set-up included
    chunk_walls   [(rounds, seconds)] per chunk, round loop only (the eval
                  after it excluded), each ended by a device synchronize
    fading_state  the final fading state [R, S, N] (None without a process)
    designs       an adaptive fleet's design trace: [(round, gamma
                  [K, S, N])], design g in effect from that round (None
                  for other fleets)
    scenario_names  the scenario axis of a grid run, length R (None
                  otherwise); ``names`` are then "scenario/scheme", R * K
    wall_compile  seconds through the end of the first chunk (set-up and
                  the first launches), device-synchronized
    wall_exec     wall - wall_compile
    wall_stage    seconds spent staging cohorts (draw, gains, the cohort
                  redesign) in population mode; with ``stream`` it
                  overlaps the chunks
    cohorts       population mode's cohort trace: [(round, idx [S, N])],
                  those devices active from that round (None otherwise)
    stage_walls   per-chunk staging seconds of the chunks this invocation
                  ran (population mode; None otherwise)
    """
    params: dict
    traces: dict
    evals: list
    names: tuple
    seeds: tuple
    wall: float
    chunk_walls: list = dataclasses.field(default_factory=list)
    fading_state: Optional[torch.Tensor] = None
    designs: Optional[list] = None
    scenario_names: Optional[tuple] = None
    wall_compile: float = 0.0
    wall_exec: float = 0.0
    wall_stage: float = 0.0
    cohorts: Optional[list] = None
    stage_walls: Optional[list] = None


def make_round_body(loss_fn: Callable, run, flat: bool = False,
                    uplink_dtype: Optional[str] = None,
                    fuse_round: Optional[bool] = None,
                    use_kernel: Optional[bool] = None,
                    metrics_hook: Optional[Callable] = None) -> Callable:
    """One FL round over the whole fleet:

        body(schemes, eta, params, fstate, draws, data, cell_seed,
             proc=None, cohort=None, cell_scheme=None)
            -> (params, fstate, metrics)

    ``schemes``: the power-control schemes (R * K on a scenario grid,
    scenario-major); ``eta`` [C] f32 step sizes; ``params``: leaves
    [C, ...]; ``fstate``: the fading state [R, S, N] (None without a
    process); ``draws``: the round's ``RoundDraws`` or ``FadingDraws``
    (rows per seed); ``data``: the stacked device shards (x [N, Dn, ...],
    y [N, Dn] int64); ``cell_seed`` [C]: the seed row of each cell.

    ``cell_scheme`` (a host int array [C], ``fl.placement``'s sharded
    blocks) makes the round run on a block of cells, any contiguous run of
    the flattened grid that may start or end inside a scheme's seeds or a
    scenario row (padded blocks repeat cell 0): ``params`` and ``eta``
    are then the block's, ``cell_seed`` and ``cell_scheme`` each cell's
    seed row and scheme.  The channel is stepped for every row as on the
    whole grid (so every block carries the same fading state), the
    coefficients are those of the schemes the block holds, gathered per
    cell, and the gradients run one scenario row's run of cells at a
    time.  Left at None, the round is the whole grid's, cell-major, with
    exactly the launches it had before blocks existed.

    The channel: when the draws carry innovations (``FadingDraws``),
    ``proc`` (a ``core.scenarios.ScenarioStack`` of R rows) steps the state
    on them; otherwise h is the draws' own ([S, N], or a replayed per-row
    [R, S, N]).  The gradients run one scenario row's cells at a time
    (``gradients``).

    ``cohort`` (population mode: the chunk's operands, made by
    ``fl.driver``) holds ``data_idx`` [S, N], each active device's data shard, which a
    minibatch gathers through; ``per_seed``, True when ``data`` is the
    full batch gathered per seed row ([S, N, Dn, ...]: the seed rows hold
    different cohorts), False when it is gathered once and shared
    ([N, Dn, ...], which keeps the plain path's GEMM shapes); and ``fade``,
    the cohort's gains, scale and LOS [S, N] for a process's step.

    ``uplink_dtype`` (default ``run.uplink_dtype``) and ``fuse_round``
    (default: fused exactly when ``flat``) follow the reference;
    ``use_kernel`` passes to the kernel dispatch (None: by device).  The
    body carries the tail it resolved as ``body.fuse`` and
    ``body.uplink_dtype``.

    ``metrics_hook`` (``telemetry.make_metrics_hook``) extends the round's
    metrics: called as ``hook(s=, noise_scale=, h=, params=)`` with the
    realized coefficients s [C, N] and noise scales [C], each cell's
    channel [C, N] and the updated params, it returns extra [C] traces.
    Left at None, the body issues exactly the launches it issues without
    it.
    """
    if uplink_dtype is None:
        uplink_dtype = getattr(run, "uplink_dtype", "f32") or "f32"
    if uplink_dtype not in ota.UPLINK_DTYPES:
        raise ValueError(f"uplink_dtype must be one of {ota.UPLINK_DTYPES}, "
                         f"got {uplink_dtype!r}")
    if uplink_dtype != "f32" and not flat:
        raise ValueError(f"uplink_dtype={uplink_dtype!r} requires the flat "
                         "aggregation path (flat=True)")
    fuse = bool(flat) if fuse_round is None else bool(fuse_round)
    if fuse and not flat:
        raise ValueError("fuse_round=True requires flat=True")

    gradients = make_gradients(loss_fn, run)

    def channel(fstate, draws, proc, cohort):
        """(fstate, h [R, S, N]) of the round."""
        fade = getattr(draws, "fade", None)
        if fade is not None:
            return proc.step(fstate, fade,
                             None if cohort is None else cohort["fade"])
        return fstate, (draws.h if draws.h.dim() == 3 else draws.h[None])

    layouts = {}

    def layout(cell_scheme, k_row, device):
        """(held schemes, each cell's position among them [Cb], each
        cell's scenario row [Cb], the runs of one scenario row) of a block
        of cells, made once per block."""
        key = (np.asarray(cell_scheme).tobytes(), k_row, str(device))
        out = layouts.get(key)
        if out is None:
            cs = np.asarray(cell_scheme, np.int64)
            held = sorted(set(cs.tolist()))
            row = cs // k_row
            cuts = [0] + [i for i in range(1, len(cs))
                          if row[i] != row[i - 1]] + [len(cs)]
            out = layouts[key] = (
                held,
                torch.as_tensor(np.searchsorted(held, cs), device=device),
                torch.as_tensor(row, device=device),
                list(zip(cuts[:-1], cuts[1:])))
        return out

    def body(schemes, eta, params, fstate, draws, data, cell_seed,
             proc=None, cohort=None, cell_scheme=None):
        x_dev, y_dev = data
        c = eta.shape[0]
        fstate, h_rows = channel(fstate, draws, proc, cohort)
        rows = h_rows.shape[0]
        k_row = len(schemes) // rows
        if cell_scheme is None:          # the whole grid, cell-major
            grads, norms = gradients(params, x_dev, y_dev, draws.idx,
                                     cell_seed, rows, cohort)
            coeffs = [pc.round_coeffs(h_rows[j // k_row], draws.coin)
                      for j, pc in enumerate(schemes)]
            s = torch.stack([sc_ for sc_, _ in coeffs]).reshape(c, -1)
            ns = torch.stack([n for _, n in coeffs]).reshape(c)
        else:                            # a block of a sharded placement
            held, pos, row, runs = layout(cell_scheme, k_row,
                                          cell_seed.device)
            grads, norms = gradients(params, x_dev, y_dev, draws.idx,
                                     cell_seed, cohort=cohort, runs=runs)
            coeffs = [schemes[j].round_coeffs(h_rows[j // k_row], draws.coin)
                      for j in held]
            s = torch.stack([sc_ for sc_, _ in coeffs])[pos, cell_seed]
            ns = torch.stack([n for _, n in coeffs])[pos, cell_seed]
        z = draws.z[cell_seed]                                      # [C, D]
        if fuse:
            params = ota.fused_round_step(grads, s, ns, z, params, eta,
                                          uplink_dtype=uplink_dtype,
                                          use_kernel=use_kernel)
        else:
            g_hat = ota.apply_round_coeffs(grads, s, ns, z, flat=flat,
                                           uplink_dtype=uplink_dtype,
                                           use_kernel=use_kernel)
            params = {
                k: (p.float() - eta.reshape((c,) + (1,) * (p.dim() - 1))
                    * g_hat[k].float()).to(p.dtype)
                for k, p in params.items()}
        metrics = {
            "grad_norm_mean": torch.mean(norms, dim=-1),
            "active_devices": torch.sum((s > 0).float(), dim=-1),
            "noise_scale": ns.float(),
        }
        if metrics_hook is not None:
            if cell_scheme is None:
                h_cells = torch.stack([h_rows[j // k_row]
                                       for j in range(len(schemes))]) \
                    .reshape(c, -1)
            else:
                h_cells = h_rows[row, cell_seed]
            metrics.update(metrics_hook(s=s, noise_scale=ns, h=h_cells,
                                        params=params))
        return params, fstate, metrics

    body.fuse, body.uplink_dtype = fuse, uplink_dtype
    return body


def make_gradients(loss_fn: Callable, run) -> Callable:
    """Per-device gradients of every cell, clipped to G_max:

        gradients(params, x_dev, y_dev, idx, cell_seed, rows=1,
                  cohort=None, runs=None)
            -> (grads {leaf: [C, N, ...]}, norms [C, N])

    ``idx`` [S, N, B] picks each seed's minibatch (None: full batch).  The
    C cells are ``rows`` equal blocks (a grid's scenarios), or the
    ``runs`` [(start, stop)] given, and each block is one
    ``torch.func.vmap`` over its cells and devices, so a scenario's cells
    run at the shapes of that scenario's own fleet.  ``cohort``
    (population mode, see ``make_round_body``): a minibatch gathers
    through its ``data_idx``; a full batch gathered per seed row runs per
    cell, one gathered once runs as the plain path."""
    def device_grad(params, x, y):
        g = grad(loss_fn)(params, (x, y))
        if run.clip_to_gmax:
            return clip_by_global_norm(g, run.gmax)
        norm = torch.sqrt(sum(torch.sum(torch.square(g[k]))
                              for k in sorted(g)))
        return g, norm

    per_device = vmap(device_grad, in_dims=(None, 0, 0))
    per_cell_batch = vmap(per_device, in_dims=(0, 0, 0))       # minibatch
    per_cell_full = vmap(per_device, in_dims=(0, None, None))  # full batch

    def block(params, x_dev, y_dev, idx, cell_seed, cohort):
        if idx is not None:
            dev_ix = torch.arange(x_dev.shape[0],
                                  device=x_dev.device)[None, :, None] \
                if cohort is None else cohort["data_idx"][..., None]
            xb = x_dev[dev_ix, idx][cell_seed]            # [C, N, B, ...]
            yb = y_dev[dev_ix, idx][cell_seed]
            return per_cell_batch(params, xb, yb)
        if cohort is not None and cohort["per_seed"]:     # [S, N, Dn, ...]
            return per_cell_batch(params, x_dev[cell_seed],
                                  y_dev[cell_seed])
        return per_cell_full(params, x_dev, y_dev)

    def gradients(params, x_dev, y_dev, idx, cell_seed, rows=1,
                  cohort=None, runs=None):
        if runs is None:
            per = cell_seed.shape[0] // rows
            runs = [(r * per, (r + 1) * per) for r in range(rows)]
        parts = [block({k: v[a:b] for k, v in params.items()}, x_dev, y_dev,
                       idx, cell_seed[a:b], cohort)
                 for a, b in runs]
        return _cat([g for g, _ in parts]), _cat([n for _, n in parts])

    return gradients


def _cat(parts):
    """Concatenate blocks along the cell axis (one block as it is)."""
    if len(parts) == 1:
        return parts[0]
    if isinstance(parts[0], dict):
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    return torch.cat(parts)


def chunk_lengths(num_rounds: int, eval_every: int, with_eval: bool,
                  cohort_rounds: Optional[int] = None) -> list:
    """Chunk lengths whose boundaries hit the eval cadence (t % eval_every
    == 0 or t == num_rounds - 1), as ``repro.fl.engine.chunk_lengths``.
    ``cohort_rounds`` adds population-cohort boundaries: the active set
    changes before every round t with t % cohort_rounds == 0, so chunks
    also end at rounds c * cohort_rounds - 1 (a cohort never straddles a
    chunk)."""
    if num_rounds <= 0:
        return []
    pts = set(range(0, num_rounds, eval_every)) if with_eval else set()
    if cohort_rounds:
        pts |= set(range(cohort_rounds - 1, num_rounds, cohort_rounds))
    if not pts:
        return [num_rounds]
    pts = sorted(pts | {num_rounds - 1})
    lengths, prev = [], -1
    for t in pts:
        lengths.append(t - prev)
        prev = t
    return lengths
