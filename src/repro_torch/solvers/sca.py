"""The batched SCA solver for the (P1) power-control design, in torch
float64, ported from ``repro.solvers.sca_jax``.

The same algorithm as the reference, step for step, with the same fixed
budgets and the same order of floating-point operations where it can be
kept, so the port lands on the reference's design (to ~1e-8 relative; the
stiff penalty stages amplify an ulp in the middle iterates, in the
reference as here, and the polish converges them again):

* Scaled variables: gamma_hat = gamma / gamma_max in (0, 1], p on the
  simplex, alpha_hat = alpha / sum(alpha_max).
* Inner solver: each SCA iteration minimizes the convex surrogate
  (11a-11e) around the anchor (the epigraph variable eliminated via tight
  (11b)) by projected Adam-style gradient descent; (11c)/(11d) enter as
  quadratic penalties on an escalating schedule, the simplex and box
  constraints by exact projection.
* Monotone descent outside the inner solver: the candidate is backtracked
  toward the anchor on the TRUE objective and taken only if it improves.
* A polish on the true objective: an adaptive stage that keeps the best
  iterate, then an Armijo stage.

Every scenario of a batch is a row of a leading [B] axis.  The reference's
``lax.scan`` loops are Python loops; its ``vmap`` of a ``while_loop`` (the
Armijo halvings) is a masked loop that runs until every row is done, rows
that are done keeping their values.  ``jax.grad`` becomes autograd of the
sum over rows (each row's objective depends on its own row only).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.sca import SCAResult
from repro_torch.core.theory import OTAParams
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.solvers import theory as tt
from repro_torch.solvers.theory import SolverParams

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Fixed iteration budgets (the reference's)."""
    max_iters: int = 16           # outer SCA iterations
    inner_iters: int = 100        # projected-gradient steps per penalty stage
    inner_lr: float = 0.03        # inner per-coordinate adaptive step size
    penalties: tuple = (1e2, 1e4, 1e6)   # (11c)/(11d) penalty schedule
    backtracks: int = 12          # true-objective backtracking halvings
    armijo_halvings: int = 20     # polish line-search halvings
    polish_adam_iters: int = 400  # adaptive polish steps (best-iterate kept)
    polish_adam_lr: float = 0.01
    polish_iters: int = 120       # Armijo polish steps (finisher)
    tol: float = 1e-6             # convergence tolerance (reported only)


DEFAULT_CONFIG = SolverConfig()


@dataclasses.dataclass
class BatchResult:
    """``solve_batch`` output: leading [B] axis on every field (numpy)."""
    gamma: np.ndarray        # [B, N] physical pre-scalers
    p: np.ndarray            # [B, N] participation levels
    alpha: np.ndarray        # [B] post-scalers
    objective: np.ndarray    # [B] true (P1) objectives
    history: np.ndarray      # [B, max_iters + 2]: start, outer iterates,
    #                          post-polish objective (monotone)
    converged: np.ndarray    # [B] bool: the outer SCA loop plateaued


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------

def project_simplex(v: torch.Tensor) -> torch.Tensor:
    """Euclidean projection onto the probability simplex (sort-based),
    along the last axis."""
    n = v.shape[-1]
    u = torch.flip(torch.sort(v, dim=-1, stable=True).values, dims=(-1,))
    css = torch.cumsum(u, dim=-1) - 1.0
    idx = torch.arange(1, n + 1, dtype=v.dtype, device=v.device)
    cond = u - css / idx > 0
    rho = torch.sum(cond, dim=-1)
    # rho = 0 only on a non-finite row (an overflowed inner step); index
    # -1 then wraps to the last entry, as the reference's take_along_axis
    # does, and the row stays non-finite for the backtracking to reject
    theta = torch.gather(css, -1, ((rho - 1) % n)[..., None])[..., 0] \
        / rho.to(v.dtype)
    return torch.clamp(v - theta[..., None], min=0.0)


def _project(x, n):
    gh = torch.clamp(x[..., :n], 1e-6, 1.0)
    p = torch.clamp(project_simplex(x[..., n:2 * n]), min=_EPS)
    ah = torch.clamp(x[..., 2 * n:], 1e-6, 2.0)
    return torch.cat([gh, p, ah], dim=-1)


def _grad(f, x):
    """f(x) [B] and its gradient with respect to x (rows independent)."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        fx = f(x)
        (g,) = torch.autograd.grad(fx.sum(), x)
    return fx.detach(), g


# ---------------------------------------------------------------------------
# the convex surrogate (11) around an anchor, penalized form
# ---------------------------------------------------------------------------

def _surrogate_fn(prm: SolverParams, gmax_arr, amax_arr, a0,
                  anchor_gh, anchor_p, anchor_ah, mu):
    """Penalized surrogate phi(x) [B] for x = [gh(N), p(N), ah(1)]."""
    n = gmax_arr.shape[-1]
    eta_l = prm.eta * prm.lsmooth
    g2 = prm.gmax**2
    g_bar = anchor_gh * gmax_arr
    a_bar = anchor_ah * a0
    p_bar = torch.clamp(anchor_p, min=1e-9)
    eps = torch.tensor(_EPS, dtype=gmax_arr.dtype, device=gmax_arr.device)

    def phi(x):
        # maximum (not clamp): at a tie it passes half the gradient, as
        # the reference's does
        gh = torch.maximum(x[..., :n], eps)
        p = torch.maximum(x[..., n:2 * n], eps)
        ah = torch.maximum(x[..., 2 * n], eps)
        gamma = gh * gmax_arr
        alpha = ah * a0
        # z_m eliminated via tight (11b)
        logz = (torch.log(g_bar * p_bar) + gamma / g_bar + p / p_bar - 2.0
                - torch.log(alpha)[..., None])
        z = torch.exp(logz)
        lin_p2 = p_bar * (2.0 * p - p_bar)
        obj = eta_l * (g2 * torch.sum(z, -1) + prm.d * prm.n0 / alpha**2
                       + torch.sum(p**2 * prm.sigma_sq, -1)
                       - g2 * torch.sum(lin_p2, -1))
        obj = obj + n * prm.kappa_sq * torch.sum((p - 1.0 / n) ** 2, -1)
        # (11c): ln alpha_m(gamma) >= linearized ln(alpha p_m)
        c11c = tt.log_alpha_of_gamma(gamma, prm) \
            - (torch.log(a_bar[..., None] * p_bar)
               + (alpha / a_bar)[..., None] + p / p_bar - 2.0)
        # (11d): concave 1/alpha bound, alpha-scaled to O(1)
        c11d = a0[..., None] * (((2.0 * a_bar - alpha) / a_bar**2)[..., None]
                                - p / amax_arr)
        pen = torch.sum(torch.clamp(c11c, max=0.0) ** 2, -1) \
            + torch.sum(torch.clamp(c11d, max=0.0) ** 2, -1)
        return obj + mu * pen

    return phi


def _inner_pgd(phi, x0, n, num_iters: int, lr: float):
    """Projected per-coordinate-adaptive gradient descent on the penalized
    surrogate (Adam-style moments + exact simplex/box projection), with a
    fixed budget; SCA descent is enforced outside, by the true-objective
    backtracking."""
    b1, b2 = 0.9, 0.999
    x = x0
    m = torch.zeros_like(x0)
    v = torch.zeros_like(x0)
    for t in range(1, num_iters + 1):
        _, g = _grad(phi, x)
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        mh = m / (1.0 - b1**t)
        vh = v / (1.0 - b2**t)
        x = _project(x - lr * mh / (torch.sqrt(vh) + 1e-12), n)
    return x


# ---------------------------------------------------------------------------
# the solve: SCA outer loop + polish
# ---------------------------------------------------------------------------

def _true_objective(gh, prm: SolverParams, gmax_arr):
    floor = torch.tensor(1e-6, dtype=gh.dtype, device=gh.device)
    return tt.p1_objective(torch.maximum(gh, floor) * gmax_arr, prm)


def _solve_rows(prm: SolverParams, gamma0: Optional[torch.Tensor],
                cfg: SolverConfig) -> dict:
    """The solve of every row of ``prm`` (batch shape [B])."""
    n = prm.num_devices
    gmax_arr = tt.gamma_max(prm)                       # [B, N]
    amax_arr = tt.alpha_max(prm)
    a0 = torch.sum(amax_arr, -1)                       # [B]
    prm_trials = prm.unsqueeze(1)
    gmax_trials = gmax_arr[:, None, :]

    gh0 = torch.ones_like(gmax_arr) if gamma0 is None else gamma0 / gmax_arr

    def true_obj(gh):
        return _true_objective(gh, prm, gmax_arr)

    def coupled(gh):
        _, a, pm = tt.participation(gh * gmax_arr, prm)
        return pm, a / a0

    gh = gh0
    pm, ah = coupled(gh0)
    obj0 = true_obj(gh0)
    obj = obj0
    thetas = 0.5 ** torch.arange(cfg.backtracks, dtype=gh.dtype,
                                 device=gh.device)
    hist = []
    for _ in range(cfg.max_iters):
        x = torch.cat([gh, pm, ah[:, None]], dim=-1)
        for mu in cfg.penalties:
            phi = _surrogate_fn(prm, gmax_arr, amax_arr, a0, gh, pm, ah, mu)
            x = _inner_pgd(phi, x, n, cfg.inner_iters, cfg.inner_lr)
        cand = torch.clamp(x[:, :n], 1e-6, 1.0)
        # true-objective backtracking toward the anchor: accept the first
        # (largest) theta that strictly improves, else stay
        trials = thetas[None, :, None] * cand[:, None, :] \
            + (1.0 - thetas[None, :, None]) * gh[:, None, :]   # [B, T, N]
        objs = _true_objective(trials, prm_trials, gmax_trials)  # [B, T]
        improves = objs < obj[:, None]
        any_imp = torch.any(improves, dim=-1)
        first = torch.argmax(improves.to(torch.int8), dim=-1)
        rows = torch.arange(gh.shape[0], device=gh.device)
        gh = torch.where(any_imp[:, None], trials[rows, first], gh)
        obj = torch.where(any_imp, objs[rows, first], obj)
        pm, ah = coupled(gh)
        hist.append(obj)

    if cfg.polish_adam_iters > 0:
        gh = _polish_adam(true_obj, gh, cfg.polish_adam_iters,
                          cfg.polish_adam_lr)
    if cfg.polish_iters > 0:
        gh = _polish(true_obj, gh, cfg.polish_iters, cfg.armijo_halvings)
    obj = true_obj(gh)
    pm, ah = coupled(gh)

    # history = [start, outer iterates..., post-polish objective]; converged
    # reports the OUTER loop's plateau
    hist = torch.stack(hist, dim=-1)
    history = torch.cat([obj0[:, None], hist, obj[:, None]], dim=-1)
    converged = torch.abs(hist[:, -1] - hist[:, -2]) \
        <= cfg.tol * torch.clamp(torch.abs(hist[:, -1]), min=1.0)
    return dict(gamma=gh * gmax_arr, p=pm, alpha=ah * a0, objective=obj,
                history=history, converged=converged)


def _polish_adam(true_obj, gh0, num_iters: int, lr: float):
    """Box-projected adaptive descent on the true objective, returning the
    best iterate seen (never worse than gh0)."""
    b1, b2 = 0.9, 0.999
    x = gh0
    m = torch.zeros_like(gh0)
    v = torch.zeros_like(gh0)
    best_x = gh0
    best_f, g = _grad(true_obj, gh0)
    for t in range(1, num_iters + 1):
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        x = torch.clamp(
            x - lr * (m / (1.0 - b1**t))
            / (torch.sqrt(v / (1.0 - b2**t)) + 1e-12), 1e-6, 1.0)
        # one pass gives this iterate's objective and the next step's
        # gradient (the reference evaluates them separately, same values)
        fx, g = _grad(true_obj, x)
        better = fx < best_f
        best_x = torch.where(better[:, None], x, best_x)
        best_f = torch.where(better, fx, best_f)
    return best_x


def _polish(true_obj, gh0, num_iters: int, halvings: int):
    """Box-projected Armijo gradient descent on the true objective.  The
    halvings of each step run, row by row, until that row's Armijo test
    passes or its budget is spent; the loop ends when every row is done."""
    gh = gh0
    t = torch.full(gh0.shape[:1], 0.1, dtype=gh0.dtype, device=gh0.device)

    def try_step(tt_, g):
        xn = torch.clamp(gh - tt_[:, None] * g, 1e-6, 1.0)
        return xn, true_obj(xn)

    for _ in range(num_iters):
        f0, g = _grad(true_obj, gh)
        gg = torch.sum(g * g, -1)
        t_fin = t
        x_fin, f_fin = try_step(t_fin, g)
        k = 0
        active = (f_fin > f0 - 1e-4 * t_fin * gg)
        while k < halvings and bool(active.any()):
            t_try = torch.where(active, 0.5 * t_fin, t_fin)
            xn, fn = try_step(t_try, g)
            t_fin = t_try
            x_fin = torch.where(active[:, None], xn, x_fin)
            f_fin = torch.where(active, fn, f_fin)
            k += 1
            active = active & (f_fin > f0 - 1e-4 * t_fin * gg)
        ok = f_fin < f0
        gh = torch.where(ok[:, None], x_fin, gh)
        t = torch.clamp(torch.where(ok, torch.clamp(t_fin * 2.0, max=1.0),
                                    0.25 * t), min=1e-12)
    return gh


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def _numpy(out: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


def solve(prm: OTAParams, gamma0: Optional[np.ndarray] = None,
          cfg: SolverConfig = DEFAULT_CONFIG,
          device: DeviceLike = None) -> SCAResult:
    """Single-scenario SCA solve on ``device`` (default: the card); a
    drop-in for ``core.sca.solve_sca``.  ``iterations`` reports the fixed
    outer budget."""
    dev = resolve_device(device)
    pt = tt.stack_params([prm], dev)
    g0 = None if gamma0 is None else torch.as_tensor(
        np.asarray(gamma0, np.float64), device=dev)[None]
    with torch.no_grad():
        out = _numpy(_solve_rows(pt, g0, cfg))
    return SCAResult(gamma=out["gamma"][0], p=out["p"][0],
                     alpha=float(out["alpha"][0]),
                     objective=float(out["objective"][0]),
                     history=[float(h) for h in out["history"][0]],
                     converged=bool(out["converged"][0]),
                     iterations=cfg.max_iters)


def solve_batch(prms: Union[Sequence[OTAParams], SolverParams],
                cfg: SolverConfig = DEFAULT_CONFIG,
                device: DeviceLike = None, placement=None) -> BatchResult:
    """Design powers for a batch of scenarios at once on ``device``
    (default: the card).

    ``prms``: a sequence of ``OTAParams`` (stacked here), or an already
    stacked ``SolverParams`` with a leading [B] axis (moved to ``device``
    and cast to float64).  All rows share the fading family and device
    count.  ``placement`` (an ``fl.placement`` object) maps the batch
    axis onto slots: ``ShardedPlacement(mesh)`` pads the rows with copies
    of row 0 to a multiple of the slot count and runs one solve per slot
    on its block (rows are independent); None, or ``VmapPlacement()``,
    is the one solve over the whole batch."""
    dev = resolve_device(device)
    if isinstance(prms, SolverParams):
        pt = prms.to(dev, torch.float64)
    else:
        pt = tt.stack_params(prms, dev)
    with torch.no_grad():
        if placement is None:
            out = _numpy(_solve_rows(pt, None, cfg))
        else:
            out = _numpy(placement.map_batch(
                lambda p: _solve_rows(p, None, cfg), pt))
    return BatchResult(gamma=out["gamma"], p=out["p"], alpha=out["alpha"],
                       objective=out["objective"], history=out["history"],
                       converged=out["converged"])


# Per-solve telemetry hook, as the reference's ``sca_jax.set_trace_hook``.
# The driver installs one around telemetry-enabled runs; unset (the
# default) the solve path is untouched.
_TRACE_HOOK: Optional[Callable] = None


def set_trace_hook(hook: Optional[Callable]) -> Optional[Callable]:
    """Install ``hook(record: dict)``, called once per redesign solve
    (``solve_batch_traced``) with {batch, iters, objective_mean,
    converged, dur}.  Returns the previous hook, for the caller to restore
    (try/finally)."""
    global _TRACE_HOOK
    prev = _TRACE_HOOK
    _TRACE_HOOK = hook
    return prev


def solve_batch_traced(prms: Union[Sequence[OTAParams], SolverParams],
                       cfg: SolverConfig = DEFAULT_CONFIG,
                       device: DeviceLike = None) -> BatchResult:
    """``solve_batch`` on the in-training redesign paths (``AdaptiveSCA``'s
    redesign and its cohort redesign), which fire the trace hook, as the
    reference's ``solve_batch_device`` does; the initial designs call
    ``solve_batch`` and fire nothing."""
    hook = _TRACE_HOOK
    t0 = time.monotonic() if hook is not None else 0.0
    out = solve_batch(prms, cfg, device)
    if hook is not None:
        hook({"batch": int(out.objective.shape[0]),
              "iters": int(cfg.max_iters),
              "objective_mean": float(np.mean(out.objective)),
              "converged": int(np.sum(out.converged)),
              "dur": round(time.monotonic() - t0, 6)})
    return out
