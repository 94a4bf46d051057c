"""Theorem-1 quantities for biased OTA-FL (paper §II-B, §III).

A copy of ``repro.core.theory`` (numpy only), kept so the port never
imports the JAX package.

Everything here is closed-form float64 numpy over the *statistical* CSI
{Lambda_m}; these functions define both the convergence bound and the SCA
objective.

Key maps (paper eqs. (5)-(10)):

    chi threshold:  |h| >= Gmax * gamma_m / sqrt(d * Es)
    E[chi_m]      = P(|h_m| >= threshold)
                  = exp(-gamma_m^2 Gmax^2 / (d Lambda_m Es))      (Rayleigh)

Off-Rayleigh (OTAParams.fading set to a rician/nakagami FadingSpec —
DESIGN.md §Scenarios), E[chi_m] comes from the family's magnitude survival
function (channel.fading_magnitude_sf) and the alpha_m maximizer gamma_max
is found numerically on the same increasing-then-decreasing branch; the
rest of the Theorem-1 algebra (zeta, bias, the (P1) objective) only sees
alpha_m and is family-agnostic.
    alpha_m(gamma)= gamma_m * E[chi_m]
    alpha         = sum_m alpha_m          (PS post-scaler)
    p_m           = alpha_m / alpha        (average participation level)

    zeta = Gmax^2 * sum_m (p_m gamma_m / alpha - p_m^2)     transmission var
         + sum_m p_m^2 sigma_m^2                            mini-batch var
         + d N0 / alpha^2                                   receiver noise

    bias = 2 N kappa^2 sum_m (p_m - 1/N)^2

    Theorem 1:  (1/T) sum_t E||grad F||^2
        <= 4 max_m (f_m(w0)-f_m^inf) / (eta T) + 2 eta L zeta + bias
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.channel import FadingSpec, fading_magnitude_sf


@dataclasses.dataclass(frozen=True)
class OTAParams:
    """Problem constants entering the bound and the power-control design."""
    d: int                    # model dimension
    gmax: float               # G_max: uniform bound on sample gradients
    es: float                 # E_s: per-sample energy budget
    n0: float                 # N0: receiver noise PSD
    gains: np.ndarray         # [N] Lambda_m
    sigma_sq: np.ndarray      # [N] per-device mini-batch gradient variance bound
    eta: float = 0.01         # learning rate (enters P1 objective weight)
    lsmooth: float = 1.0      # L-smoothness constant
    kappa_sq: float = 1.0     # kappa^2: gradient dissimilarity bound
    fading: Optional[FadingSpec] = None   # None = Rayleigh (paper baseline)
    dropout: float = 0.0      # per-round device dropout prob (scenario dynamics)

    @property
    def num_devices(self) -> int:
        return int(np.asarray(self.gains).shape[0])

    @property
    def is_rayleigh(self) -> bool:
        return self.fading is None or self.fading.family == "rayleigh"

    def replace(self, **kw) -> "OTAParams":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# alpha_m(gamma) and its extremes
# ---------------------------------------------------------------------------

def trunc_exponent(gamma: np.ndarray, p: OTAParams) -> np.ndarray:
    """gamma^2 Gmax^2 / (d Lambda Es)  — the exponent in E[chi]."""
    gamma = np.asarray(gamma, dtype=np.float64)
    return gamma**2 * p.gmax**2 / (p.d * p.gains * p.es)


def expected_participation_indicator(gamma: np.ndarray, p: OTAParams) -> np.ndarray:
    """E[chi_{m,t}] = (1 - p_dropout) * P(|h_m| >= chi_threshold(gamma_m)).

    A dropped-out device presents h = 0 and never clears the threshold, so
    round dropout scales E[chi] by (1 - p_dropout).  Rayleigh keeps the
    exact paper eq. (5) closed form exp(-gamma^2 Gmax^2 / (d Lambda Es));
    other families use the FadingSpec's magnitude survival function
    (channel.fading_magnitude_sf).
    """
    if p.is_rayleigh:
        sf = np.exp(-trunc_exponent(gamma, p))
    else:
        sf = fading_magnitude_sf(p.gains, chi_threshold(gamma, p), p.fading)
    if p.dropout > 0:
        sf = (1.0 - p.dropout) * sf
    return sf


def log_alpha_of_gamma(gamma: np.ndarray, p: OTAParams) -> np.ndarray:
    """ln alpha_m(gamma).  Rayleigh keeps the exact cancellation-free form
    ln(gamma) - trunc_exponent used by the SCA constraint (11c)."""
    gamma = np.asarray(gamma, dtype=np.float64)
    if p.is_rayleigh:
        out = np.log(gamma) - trunc_exponent(gamma, p)
        if p.dropout > 0:
            out = out + np.log1p(-p.dropout)
        return out
    return np.log(np.maximum(alpha_of_gamma(gamma, p), 1e-300))


def alpha_of_gamma(gamma: np.ndarray, p: OTAParams) -> np.ndarray:
    """alpha_m = gamma_m * E[chi_m]."""
    return np.asarray(gamma, dtype=np.float64) * expected_participation_indicator(gamma, p)


def _rayleigh_gamma_max(p: OTAParams) -> np.ndarray:
    return np.sqrt(p.d * p.gains * p.es / (2.0 * p.gmax**2))


# Two-stage log grid for the numeric (non-Rayleigh) gamma_max search:
# (lo, hi, points) multipliers around the previous stage's maximizer.  Shared
# with the jnp port in repro.solvers.theory_jax so both backends pick the
# same grid candidate (parity to float rounding, not just grid resolution).
GAMMA_MAX_GRID_COARSE = (0.05, 20.0, 241)
GAMMA_MAX_GRID_FINE = (0.95, 1.05, 101)


def gamma_max(p: OTAParams) -> np.ndarray:
    """Maximizer of alpha_m(gamma) per device.

    Rayleigh: closed form gamma_{m,max} = sqrt(d Lambda Es / (2 Gmax^2)).
    Other families: alpha_m(gamma) = gamma * SF(c gamma) is still unimodal
    (SF log-concave for Rician and Nakagami m >= 1/2), so a two-stage log
    grid around the Rayleigh maximizer finds it to ~1e-4 relative accuracy.
    """
    g_ray = _rayleigh_gamma_max(p)
    if p.is_rayleigh:
        return g_ray

    def argmax_on(grid):  # grid: [N, G]
        chi = chi_threshold(grid, p)
        vals = grid * fading_magnitude_sf(p.gains[:, None], chi, p.fading)
        return grid[np.arange(grid.shape[0]), np.argmax(vals, axis=1)]

    coarse = argmax_on(g_ray[:, None]
                       * np.geomspace(*GAMMA_MAX_GRID_COARSE)[None, :])
    fine = argmax_on(coarse[:, None]
                     * np.geomspace(*GAMMA_MAX_GRID_FINE)[None, :])
    return fine


def alpha_max(p: OTAParams) -> np.ndarray:
    """alpha_{m,max} = alpha_m(gamma_{m,max})  (= sqrt(d Lambda Es / (2 e
    Gmax^2)) in closed form under Rayleigh; dropout scales it by 1-p since
    it rescales alpha_m uniformly without moving the maximizer)."""
    if p.is_rayleigh:
        amax = np.sqrt(p.d * p.gains * p.es / (2.0 * np.e * p.gmax**2))
        return (1.0 - p.dropout) * amax if p.dropout > 0 else amax
    return alpha_of_gamma(gamma_max(p), p)


def chi_threshold(gamma: np.ndarray, p: OTAParams) -> np.ndarray:
    """|h| threshold below which device m stays silent: Gmax gamma / sqrt(d Es)."""
    return p.gmax * np.asarray(gamma, dtype=np.float64) / np.sqrt(p.d * p.es)


def invert_alpha(alpha_target: np.ndarray, p: OTAParams) -> np.ndarray:
    """Smaller root gamma_{m,1} of alpha_m(gamma) = alpha_target (per device).

    alpha_m(gamma) is quasi-concave with max at gamma_max; the paper restricts
    to the branch gamma <= gamma_max (constraint (ii)), where the map is
    increasing.  Solved by bisection.
    """
    alpha_target = np.asarray(alpha_target, dtype=np.float64)
    amax = alpha_max(p)
    if np.any(alpha_target > amax * (1 + 1e-12)):
        raise ValueError("alpha_target exceeds alpha_max; infeasible")
    gmax_arr = gamma_max(p)
    lo = np.zeros_like(gmax_arr)
    hi = gmax_arr.copy()
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        val = alpha_of_gamma(mid, p)
        go_up = val < alpha_target
        lo = np.where(go_up, mid, lo)
        hi = np.where(go_up, hi, mid)
    return 0.5 * (lo + hi)


# ---------------------------------------------------------------------------
# Participation, variance and the bound
# ---------------------------------------------------------------------------

def participation(gamma: np.ndarray, p: OTAParams):
    """Return (alpha_m[N], alpha, p_m[N]) for pre-scalers gamma."""
    am = alpha_of_gamma(gamma, p)
    a = float(np.sum(am))
    if a <= 0:
        raise ValueError("alpha = 0: all devices silent")
    return am, a, am / a


def zeta_terms(gamma: np.ndarray, p: OTAParams):
    """The three components of the gradient-estimation variance zeta (eq. 10).

    Returns dict with 'transmission', 'minibatch', 'noise', 'total'.
    """
    _, a, pm = participation(gamma, p)
    gamma = np.asarray(gamma, dtype=np.float64)
    tx = p.gmax**2 * float(np.sum(pm * gamma / a - pm**2))
    mb = float(np.sum(pm**2 * np.asarray(p.sigma_sq, dtype=np.float64)))
    nz = p.d * p.n0 / a**2
    return {"transmission": tx, "minibatch": mb, "noise": nz,
            "total": tx + mb + nz}


def bias_term(pm: np.ndarray, p: OTAParams) -> float:
    """2 N kappa^2 sum_m (p_m - 1/N)^2."""
    n = p.num_devices
    pm = np.asarray(pm, dtype=np.float64)
    return 2.0 * n * p.kappa_sq * float(np.sum((pm - 1.0 / n) ** 2))


def p1_objective(gamma: np.ndarray, p: OTAParams) -> float:
    """The (P1) objective: 2 eta L zeta + bias  (Theorem 1 minus init term)."""
    z = zeta_terms(gamma, p)["total"]
    _, _, pm = participation(gamma, p)
    return 2.0 * p.eta * p.lsmooth * z + bias_term(pm, p)


def theorem1_bound(gamma: np.ndarray, p: OTAParams, init_gap: float,
                   num_rounds: int) -> dict:
    """Full Theorem-1 bound, split into its three components.

    init_gap = max_m (f_m(w0) - f_m^inf).
    """
    z = zeta_terms(gamma, p)
    _, _, pm = participation(gamma, p)
    opt = 4.0 * init_gap / (p.eta * num_rounds)
    var = 2.0 * p.eta * p.lsmooth * z["total"]
    bias = bias_term(pm, p)
    return {"optimization": opt, "variance": var, "bias": bias,
            "total": opt + var + bias, "zeta": z, "p": pm}


def uniform_feasible(p: OTAParams) -> bool:
    """Whether the zero-bias point p_m = 1/N is feasible, i.e. there exists
    alpha with alpha/N <= alpha_{m,max} for all m: alpha <= N * min alpha_max."""
    return bool(np.min(alpha_max(p)) > 0)


def zero_bias_gamma(p: OTAParams, slack: float = 1.0) -> np.ndarray:
    """Pre-scalers enforcing zero average bias (p_m = 1/N exactly).

    Sets every alpha_m to the same value slack * min_m alpha_{m,max} (the
    weakest device binds — the paper's 'constrained by the worst channel'
    regime), and inverts alpha_m(gamma) on the increasing branch.
    """
    if not (0.0 < slack <= 1.0):
        raise ValueError("slack in (0, 1]")
    target = slack * float(np.min(alpha_max(p)))
    return invert_alpha(np.full(p.num_devices, target), p)
