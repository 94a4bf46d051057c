"""Successive convex approximation for the OTA power-control design (P1).

A copy of ``repro.core.sca``'s scipy SLSQP solver, kept so the port never
imports the JAX package; ``power_control.make_sca(method="scipy")`` runs
it.

Paper §III-B: minimize over pre-scalers {gamma_m}

    J(gamma) = 2 eta L zeta(gamma) + 2 N kappa^2 sum_m (p_m(gamma) - 1/N)^2

The problem is rewritten over coupled variables X = ({gamma_m},{p_m},alpha)
with coupling alpha_m(gamma_m) = alpha p_m, and solved by SCA: each iteration
solves the convex surrogate (11a)-(11e) around the current anchor.

Implementation notes (this container has no CVX):
  * The epigraph variable z_m of (11b) is eliminated in closed form — the
    objective is increasing in z_m, so at the optimum (11b) is tight:
        z_m = exp( ln(g_bar p_bar) + gamma/g_bar + p/p_bar - 2 ) / alpha,
    which is jointly convex in (gamma, p, alpha) (exp of affine minus
    log-concave alpha).
  * Each convex subproblem is solved with scipy SLSQP in *scaled* variables
    (gamma_hat = gamma/gamma_max in (0,1], alpha_hat = alpha/sum(alpha_max))
    so all decision variables are O(1) despite physical scales ~1e-9.
  * After each subproblem we restore the exact coupling by recomputing
    (alpha_m, alpha, p) from gamma, evaluate the TRUE objective, and
    backtrack toward the anchor if the surrogate step overshot — SCA descent
    is therefore guaranteed monotone.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
from scipy.optimize import minimize

from repro_torch.core import theory
from repro_torch.core.theory import OTAParams

_EPS = 1e-12


@dataclasses.dataclass
class SCAResult:
    gamma: np.ndarray          # [N] optimized pre-scalers (physical units)
    p: np.ndarray              # [N] participation levels
    alpha: float               # post-scaler
    objective: float           # true (P1) objective at gamma
    history: list              # per-iteration true objective
    converged: bool
    iterations: int


def _pack(gh: np.ndarray, p: np.ndarray, ah: float) -> np.ndarray:
    return np.concatenate([gh, p, [ah]])


def _unpack(x: np.ndarray, n: int):
    return x[:n], x[n:2 * n], x[2 * n]


def _subproblem(anchor_gh, anchor_p, anchor_ah, prm: OTAParams,
                gmax_arr, amax_arr, a0, maxiter=200):
    """Solve the convex surrogate (11) around the given anchor (scaled vars).

    Returns scaled solution (gh, p, ah).
    """
    n = prm.num_devices
    eta_l = prm.eta * prm.lsmooth
    g2 = prm.gmax**2
    sig = np.asarray(prm.sigma_sq, dtype=np.float64)
    # physical anchors
    g_bar = anchor_gh * gmax_arr
    a_bar = anchor_ah * a0
    p_bar = np.maximum(anchor_p, 1e-9)

    def split(x):
        gh, p, ah = _unpack(x, n)
        return np.maximum(gh, _EPS), np.maximum(p, _EPS), max(ah, _EPS)

    def objective(x):
        gh, p, ah = split(x)
        gamma = gh * gmax_arr
        alpha = ah * a0
        # z_m eliminated via tight (11b)
        logz = (np.log(g_bar * p_bar) + gamma / g_bar + p / p_bar - 2.0
                - np.log(alpha))
        z = np.exp(logz)
        lin_p2 = p_bar * (2.0 * p - p_bar)           # linearized -p^2 (sign folded below)
        obj = eta_l * (g2 * np.sum(z) + prm.d * prm.n0 / alpha**2
                       + np.sum(p**2 * sig) - g2 * np.sum(lin_p2))
        obj += prm.num_devices * prm.kappa_sq * np.sum((p - 1.0 / n) ** 2)
        return obj

    def con_11c(x):
        # ln alpha_m(gamma) - ln(a_bar p_bar) - a/a_bar - p/p_bar + 2 >= 0
        # (Rayleigh: ln alpha_m = ln gamma - gamma^2 G^2/(d Lam Es) exactly;
        # other fading families use their closed-form E[chi].)
        gh, p, ah = split(x)
        gamma = gh * gmax_arr
        alpha = ah * a0
        rhs = theory.log_alpha_of_gamma(gamma, prm)
        lhs = np.log(a_bar * p_bar) + alpha / a_bar + p / p_bar - 2.0
        return rhs - lhs

    def con_11d(x):
        # (2 a_bar - alpha)/a_bar^2 - p/alpha_max >= 0
        gh, p, ah = split(x)
        alpha = ah * a0
        return (2.0 * a_bar - alpha) / a_bar**2 - p / amax_arr

    def con_simplex(x):
        _, p, _ = split(x)
        return np.sum(p) - 1.0

    x0 = _pack(anchor_gh, anchor_p, anchor_ah)
    bounds = ([(1e-6, 1.0)] * n) + ([(1e-9, 1.0)] * n) + [(1e-6, 2.0)]
    cons = [
        {"type": "ineq", "fun": con_11c},
        {"type": "ineq", "fun": con_11d},
        {"type": "eq", "fun": con_simplex},
    ]
    res = minimize(objective, x0, method="SLSQP", bounds=bounds,
                   constraints=cons, options={"maxiter": maxiter,
                                              "ftol": 1e-12})
    gh, p, ah = split(res.x)
    return gh, p, ah


def _coupled_state(gamma: np.ndarray, prm: OTAParams):
    """Restore the exact coupling: (p, alpha) implied by gamma."""
    am, a, pm = theory.participation(gamma, prm)
    return pm, a


def solve_sca(prm: OTAParams, gamma0: Optional[np.ndarray] = None,
              max_iters: int = 30, tol: float = 1e-6,
              backtracks: int = 12) -> SCAResult:
    """Run the SCA loop of §III-B. Monotone descent on the true objective."""
    gmax_arr = theory.gamma_max(prm)
    amax_arr = theory.alpha_max(prm)
    a0 = float(np.sum(amax_arr))

    if gamma0 is None:
        gamma0 = gmax_arr.copy()          # max-participation feasible start
    gamma = np.asarray(gamma0, dtype=np.float64)
    pm, a = _coupled_state(gamma, prm)
    obj = theory.p1_objective(gamma, prm)
    history = [obj]

    converged = False
    it = 0
    for it in range(1, max_iters + 1):
        gh, p_s, ah = _subproblem(gamma / gmax_arr, pm, a / a0, prm,
                                  gmax_arr, amax_arr, a0)
        cand = gh * gmax_arr
        # Backtracking line search between anchor and subproblem solution,
        # evaluating the TRUE objective with exact coupling restored.
        theta = 1.0
        best_gamma, best_obj = gamma, obj
        for _ in range(backtracks):
            trial = theta * cand + (1.0 - theta) * gamma
            trial_obj = theory.p1_objective(trial, prm)
            if trial_obj < best_obj:
                best_gamma, best_obj = trial, trial_obj
                break
            theta *= 0.5
        if best_obj >= obj - tol * max(1.0, abs(obj)):
            converged = True
            gamma, obj = best_gamma, best_obj
            pm, a = _coupled_state(gamma, prm)
            history.append(obj)
            break
        gamma, obj = best_gamma, best_obj
        pm, a = _coupled_state(gamma, prm)
        history.append(obj)

    return SCAResult(gamma=gamma, p=pm, alpha=a, objective=obj,
                     history=history, converged=converged, iterations=it)


def solve_direct(prm: OTAParams, num_starts: int = 8,
                 seed: int = 0) -> SCAResult:
    """Direct multi-start box-constrained minimization of the true (P1)
    objective over gamma_hat in (0,1]^N.  Used as an oracle to validate the
    SCA solution quality in tests/benchmarks (not part of the paper's method).
    """
    gmax_arr = theory.gamma_max(prm)
    rng = np.random.default_rng(seed)
    n = prm.num_devices

    def f(gh):
        return theory.p1_objective(np.maximum(gh, 1e-6) * gmax_arr, prm)

    best = None
    starts = [np.ones(n), np.full(n, 0.5)]
    starts += [rng.uniform(0.05, 1.0, size=n) for _ in range(num_starts - 2)]
    for x0 in starts:
        res = minimize(f, x0, method="L-BFGS-B",
                       bounds=[(1e-6, 1.0)] * n,
                       options={"maxiter": 500})
        if best is None or res.fun < best.fun:
            best = res
    gamma = np.maximum(best.x, 1e-6) * gmax_arr
    pm, a = _coupled_state(gamma, prm)
    return SCAResult(gamma=gamma, p=pm, alpha=a,
                     objective=theory.p1_objective(gamma, prm),
                     history=[best.fun], converged=True, iterations=1)
