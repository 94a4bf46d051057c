"""The Theorem-1 quantities in torch float64, ported from
``repro.solvers.theory_jax``.

``core/theory.py`` is float64 numpy/scipy, one scenario at a time.  This
module computes the same maps on tensors held in a ``SolverParams``, with
any leading batch shape, so the SCA solver (``solvers.sca``) can
differentiate them with autograd and run a batch of scenarios at once.

Shapes: every scalar field has the batch shape (``()`` for one scenario,
``[B]`` for a stack); ``gains``, ``sigma_sq`` and ``fading_param`` have the
batch shape plus the device axis [N].  A ``gamma`` argument has the batch
shape plus [N] (or more axes between them: see ``SolverParams.unsqueeze``).

The Rician magnitude survival function is the Poisson-mixture series of
Marcum's Q_1,

    Q_1(a, b) = sum_k e^{-a^2/2} (a^2/2)^k / k! * Q(k+1, b^2/2),

with Q the regularized upper incomplete gamma (``torch.special.gammaincc``)
and ``_MARCUM_TERMS`` terms, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.theory import (GAMMA_MAX_GRID_COARSE,
                                     GAMMA_MAX_GRID_FINE, OTAParams)
from repro_torch.device import DeviceLike, resolve_device

# Terms in the Marcum-Q_1 Poisson-mixture series (Rician SF).  The k-th
# weight is Poisson(K)(k), so 96 terms cover K-factors to ~40 at f64.
_MARCUM_TERMS = 96

_SCALARS = ("d", "gmax", "es", "n0", "eta", "lsmooth", "kappa_sq", "dropout")
_VECTORS = ("gains", "sigma_sq", "fading_param")


@dataclasses.dataclass(frozen=True)
class SolverParams:
    """Tensor view of ``theory.OTAParams`` (+ the fading family's
    parameter), float64, with an optional leading batch shape.

    ``fading_param`` holds the per-device family parameter ([N]): the
    Rician K-factor or Nakagami m; ones (unused) for Rayleigh.  ``family``
    is shared by every batch row.
    """
    d: torch.Tensor
    gmax: torch.Tensor
    es: torch.Tensor
    n0: torch.Tensor
    gains: torch.Tensor
    sigma_sq: torch.Tensor
    eta: torch.Tensor
    lsmooth: torch.Tensor
    kappa_sq: torch.Tensor
    dropout: torch.Tensor
    fading_param: torch.Tensor
    family: str = "rayleigh"

    @property
    def num_devices(self) -> int:
        return int(self.gains.shape[-1])

    @property
    def is_rayleigh(self) -> bool:
        return self.family == "rayleigh"

    def _map(self, scalar: Callable, vector: Callable) -> "SolverParams":
        kw = {f: scalar(getattr(self, f)) for f in _SCALARS}
        kw.update({f: vector(getattr(self, f)) for f in _VECTORS})
        return SolverParams(**kw, family=self.family)

    def unsqueeze(self, dim: int) -> "SolverParams":
        """Insert a size-1 axis at ``dim`` (counted from the front, inside
        the batch shape or just after it) in every field: the params then
        broadcast over an extra axis of gamma at that place."""
        return self._map(lambda t: t.unsqueeze(dim), lambda t: t.unsqueeze(dim))

    def per_device_grid(self) -> "SolverParams":
        """The device fields with a trailing axis: they broadcast over a
        gamma grid [..., N, G] (the scalars broadcast by shape)."""
        return self._map(lambda t: t, lambda t: t[..., None])

    def to(self, device=None, dtype=None) -> "SolverParams":
        """Every field moved to ``device`` and cast to ``dtype``."""
        def f(t):
            return t.to(device=device, dtype=dtype)
        return self._map(f, f)


def _sc(v: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """A scalar field ``v`` shaped to broadcast against ``ref`` (whose
    trailing axes are the device axis and any grid axis)."""
    return v.reshape(tuple(v.shape) + (1,) * (ref.dim() - v.dim()))


def from_ota(p: OTAParams, device: DeviceLike = None) -> SolverParams:
    """Lift a (numpy) ``OTAParams`` into float64 tensors on ``device``
    (default: the card)."""
    dev = resolve_device(device)
    n = p.num_devices
    family = "rayleigh" if p.is_rayleigh else p.fading.family
    if family == "rician":
        fparam = np.broadcast_to(
            np.asarray(p.fading.rician_k, np.float64), (n,))
    elif family == "nakagami":
        fparam = np.broadcast_to(
            np.asarray(p.fading.nakagami_m, np.float64), (n,))
    else:
        fparam = np.ones(n)

    def as_t(v):
        return torch.as_tensor(np.array(v, np.float64), device=dev)
    return SolverParams(
        d=as_t(p.d), gmax=as_t(p.gmax), es=as_t(p.es), n0=as_t(p.n0),
        gains=as_t(p.gains), sigma_sq=as_t(p.sigma_sq), eta=as_t(p.eta),
        lsmooth=as_t(p.lsmooth), kappa_sq=as_t(p.kappa_sq),
        dropout=as_t(p.dropout), fading_param=as_t(fparam), family=family)


def stack_params(prms: Sequence[OTAParams],
                 device: DeviceLike = None) -> SolverParams:
    """Stack scenarios into one SolverParams with a leading [B] axis.

    All scenarios must share the fading family and device count;
    everything else varies per batch row."""
    ps = [from_ota(p, device) for p in prms]
    if not ps:
        raise ValueError("stack_params needs at least one OTAParams")
    fam = {p.family for p in ps}
    if len(fam) > 1:
        raise ValueError(f"cannot stack mixed fading families {sorted(fam)}")
    kw = {f: torch.stack([getattr(p, f) for p in ps])
          for f in _SCALARS + _VECTORS}
    return SolverParams(**kw, family=ps[0].family)


# ---------------------------------------------------------------------------
# Fading-family survival functions
# ---------------------------------------------------------------------------

def marcum_q1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Marcum Q_1(a, b) by the Poisson-mixture series (see module doc)."""
    a, b = torch.broadcast_tensors(a, b)
    lam = 0.5 * a**2                       # Poisson mean
    x = 0.5 * b**2
    k = torch.arange(_MARCUM_TERMS, dtype=a.dtype, device=a.device)
    k = k.reshape((1,) * a.dim() + (_MARCUM_TERMS,))
    tiny = torch.tensor(1e-300, dtype=a.dtype, device=a.device)
    logw = k * torch.log(torch.maximum(lam[..., None], tiny)) \
        - lam[..., None] - torch.lgamma(k + 1.0)
    # lam == 0 (K = 0, pure Rayleigh limit): only the k = 0 term survives.
    w = torch.where(lam[..., None] > 0, torch.exp(logw),
                    (k == 0).to(a.dtype))
    tails = torch.special.gammaincc(k + 1.0, x[..., None])
    s = torch.sum(w * tails, dim=-1)
    return torch.minimum(torch.maximum(s, torch.zeros_like(s)),
                         torch.ones_like(s))


def magnitude_sf(gains: torch.Tensor, x: torch.Tensor, fparam: torch.Tensor,
                 family: str) -> torch.Tensor:
    """P(|h_m| >= x): the mirror of ``channel.fading_magnitude_sf``;
    ``fparam`` (the K-factor or m) broadcasts like ``gains``."""
    if family == "rician":
        nu = torch.sqrt(gains * fparam / (fparam + 1.0))
        sigma = torch.sqrt(gains / (2.0 * (fparam + 1.0)))
        return marcum_q1(nu / sigma, x / sigma)
    if family == "nakagami":
        arg = fparam * x**2 / gains
        return torch.special.gammaincc(fparam.expand_as(arg), arg)
    return torch.exp(-x**2 / gains)


# ---------------------------------------------------------------------------
# alpha_m(gamma) and its extremes
# ---------------------------------------------------------------------------

def trunc_exponent(gamma, p: SolverParams):
    return gamma**2 * _sc(p.gmax, gamma)**2 \
        / (_sc(p.d, gamma) * p.gains * _sc(p.es, gamma))


def chi_threshold(gamma, p: SolverParams):
    return _sc(p.gmax, gamma) * gamma / torch.sqrt(_sc(p.d, gamma)
                                                   * _sc(p.es, gamma))


def expected_participation_indicator(gamma, p: SolverParams):
    if p.is_rayleigh:
        sf = torch.exp(-trunc_exponent(gamma, p))
    else:
        sf = magnitude_sf(p.gains, chi_threshold(gamma, p), p.fading_param,
                          p.family)
    return (1.0 - _sc(p.dropout, gamma)) * sf


def alpha_of_gamma(gamma, p: SolverParams):
    return gamma * expected_participation_indicator(gamma, p)


def log_alpha_of_gamma(gamma, p: SolverParams):
    """ln alpha_m(gamma); Rayleigh keeps the cancellation-free closed form
    used by the SCA constraint (11c)."""
    if p.is_rayleigh:
        return torch.log(gamma) - trunc_exponent(gamma, p) \
            + torch.log1p(-_sc(p.dropout, gamma))
    tiny = torch.tensor(1e-300, dtype=gamma.dtype, device=gamma.device)
    return torch.log(torch.maximum(alpha_of_gamma(gamma, p), tiny))


def _rayleigh_gamma_max(p: SolverParams):
    g = p.gains
    return torch.sqrt(_sc(p.d, g) * g * _sc(p.es, g)
                      / (2.0 * _sc(p.gmax, g)**2))


def gamma_max(p: SolverParams):
    """Per-device maximizer of alpha_m; the same two-stage log grid as the
    numpy path (shared ``GAMMA_MAX_GRID_*`` constants) off-Rayleigh."""
    g_ray = _rayleigh_gamma_max(p)
    if p.is_rayleigh:
        return g_ray
    pg = p.per_device_grid()

    def argmax_on(grid):          # [..., N, G]
        vals = grid * magnitude_sf(pg.gains, chi_threshold(grid, pg),
                                   pg.fading_param, p.family)
        return torch.gather(grid, -1,
                            torch.argmax(vals, dim=-1, keepdim=True))[..., 0]

    def geom(spec):
        return torch.as_tensor(np.geomspace(*spec), dtype=g_ray.dtype,
                               device=g_ray.device)
    coarse = argmax_on(g_ray[..., None] * geom(GAMMA_MAX_GRID_COARSE))
    return argmax_on(coarse[..., None] * geom(GAMMA_MAX_GRID_FINE))


def alpha_max(p: SolverParams):
    if p.is_rayleigh:
        g = p.gains
        amax = torch.sqrt(_sc(p.d, g) * g * _sc(p.es, g)
                          / (2.0 * np.e * _sc(p.gmax, g)**2))
        return (1.0 - _sc(p.dropout, g)) * amax
    return alpha_of_gamma(gamma_max(p), p)


# ---------------------------------------------------------------------------
# Participation, variance, objective
# ---------------------------------------------------------------------------

def participation(gamma, p: SolverParams):
    am = alpha_of_gamma(gamma, p)
    a = torch.sum(am, dim=-1)
    return am, a, am / a[..., None]


def zeta_terms(gamma, p: SolverParams):
    _, a, pm = participation(gamma, p)
    tx = p.gmax**2 * torch.sum(pm * gamma / a[..., None] - pm**2, dim=-1)
    mb = torch.sum(pm**2 * p.sigma_sq, dim=-1)
    nz = p.d * p.n0 / a**2
    return {"transmission": tx, "minibatch": mb, "noise": nz,
            "total": tx + mb + nz}


def bias_term(pm, p: SolverParams):
    n = pm.shape[-1]
    return 2.0 * n * p.kappa_sq * torch.sum((pm - 1.0 / n) ** 2, dim=-1)


def p1_objective(gamma, p: SolverParams):
    z = zeta_terms(gamma, p)["total"]
    _, _, pm = participation(gamma, p)
    return 2.0 * p.eta * p.lsmooth * z + bias_term(pm, p)
