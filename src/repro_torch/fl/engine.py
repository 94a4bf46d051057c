"""One FL round of the fleet, ported from ``repro.fl.engine``.

The reference compiles its rounds into ``lax.scan`` chunks and vmaps them
over the [K scheme x S seed] grid.  PyTorch runs eagerly, so here the grid
is a leading cell axis C = K * S on every tensor (cell c is scheme c // S,
seed c % S), and ``fl.driver`` runs the rounds as a Python loop.  A round:

  1. per-device gradients over [C, N] (``torch.func.vmap`` of
     ``torch.func.grad``), clipped to G_max;
  2. every scheme's ``round_coeffs`` on the round's fading (one row per
     seed, shared by the K schemes);
  3. the round tail: fused (kernel K1: uplink, superposition, noise and
     SGD step in one launch), or unfused (kernel K2 on the flat path, or
     the per-leaf oracle) followed by the SGD step.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

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
    """
    params: dict
    traces: dict
    evals: list
    names: tuple
    seeds: tuple
    wall: float
    chunk_walls: list = dataclasses.field(default_factory=list)


def make_round_body(loss_fn: Callable, run, flat: bool = False,
                    uplink_dtype: Optional[str] = None,
                    fuse_round: Optional[bool] = None,
                    use_kernel: Optional[bool] = None) -> Callable:
    """One FL round over the whole fleet:

        body(schemes, eta, params, draws, data, cell_seed) -> (params, metrics)

    ``schemes``: the K power-control schemes; ``eta`` [C] f32 step sizes;
    ``params``: leaves [C, ...]; ``draws``: the round's ``RoundDraws`` (rows
    per seed); ``data``: the stacked device shards (x [N, Dn, ...],
    y [N, Dn] int64); ``cell_seed`` [C]: the seed row of each cell.

    ``uplink_dtype`` (default ``run.uplink_dtype``) and ``fuse_round``
    (default: fused exactly when ``flat``) follow the reference;
    ``use_kernel`` passes to the kernel dispatch (None: by device).  The
    body carries the tail it resolved as ``body.fuse`` and
    ``body.uplink_dtype``.
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

    def body(schemes, eta, params, draws, data, cell_seed):
        x_dev, y_dev = data
        c = eta.shape[0]
        if draws.idx is not None:
            dev_ix = torch.arange(x_dev.shape[0],
                                  device=x_dev.device)[None, :, None]
            xb = x_dev[dev_ix, draws.idx][cell_seed]      # [C, N, B, ...]
            yb = y_dev[dev_ix, draws.idx][cell_seed]
            grads, norms = per_cell_batch(params, xb, yb)
        else:
            grads, norms = per_cell_full(params, x_dev, y_dev)
        coeffs = [pc.round_coeffs(draws.h, draws.coin) for pc in schemes]
        s = torch.stack([sc for sc, _ in coeffs]).reshape(c, -1)    # [C, N]
        ns = torch.stack([n for _, n in coeffs]).reshape(c)         # [C]
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
        return params, metrics

    body.fuse, body.uplink_dtype = fuse, uplink_dtype
    return body


def chunk_lengths(num_rounds: int, eval_every: int, with_eval: bool) -> list:
    """Chunk lengths whose boundaries hit the eval cadence (t % eval_every
    == 0 or t == num_rounds - 1), as ``repro.fl.engine.chunk_lengths``."""
    if num_rounds <= 0:
        return []
    pts = set(range(0, num_rounds, eval_every)) if with_eval else set()
    if not pts:
        return [num_rounds]
    pts = sorted(pts | {num_rounds - 1})
    lengths, prev = [], -1
    for t in pts:
        lengths.append(t - prev)
        prev = t
    return lengths
