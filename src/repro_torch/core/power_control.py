"""OTA power-control schemes: the paper's SCA design and the Fig.-2
baselines, ported from ``repro.core.power_control``.

Every scheme maps one round's complex fading ``h [S, N]`` (one row per
seed) and the ``bbfl_alternative`` coin ``[S]`` to

    (s [S, N], noise_scale [S])   with   g_hat = sum_m s_m g_m + noise_scale z

The designs are float64 numpy, built once on the host; the round
coefficients are computed in float32 from f32 copies of the design leaves,
as the reference does (its leaves enter the compiled round as f32 without
x64).  Only the ``dropout_aware=False`` branches are ported: device dropout
belongs to the scenario layer.

  sca               proposed: per-device gamma_m from the SCA solver,
                    truncated channel inversion, statistical CSI at the PS.
  lcpc              common pre-scaler, grid-optimized with statistical CSI.
  vanilla           full channel inversion, common scale set by the weakest
                    instantaneous channel (global instantaneous CSI).
  opc               per-round MSE-optimal power control (global CSI).
  bbfl_interior     schedule only devices within R_in.
  bbfl_alternative  randomly alternate full/interior scheduling.
  ideal             noiseless FedAvg (upper reference).
  zero_bias         truncated inversion with p_m = 1/N exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.core import sca as sca_mod
from repro_torch.core import theory
from repro_torch.core.channel import Deployment
from repro_torch.core.theory import OTAParams


@dataclasses.dataclass
class PowerControl:
    """Base: time-invariant design state + per-round coefficient map."""
    name: str = "base"
    gamma: Optional[np.ndarray] = None   # [N] device pre-scalers
    alpha: Optional[float] = None        # PS post-scaler
    p: Optional[np.ndarray] = None       # [N] avg participation levels
    _f32: dict = dataclasses.field(default_factory=dict, repr=False,
                                   compare=False)

    def leaf(self, field: str, device: torch.device) -> torch.Tensor:
        """A design leaf as an f32 tensor on ``device`` (made once)."""
        key = (field, str(device))
        t = self._f32.get(key)
        if t is None:
            t = torch.as_tensor(np.asarray(getattr(self, field), np.float32),
                                device=device)
            self._f32[key] = t
        return t

    def round_coeffs(self, h: torch.Tensor, coin: torch.Tensor):
        """(s [S, N], noise_scale [S]) for complex fading h [S, N]."""
        raise NotImplementedError


def _bmax(prm: OTAParams) -> float:
    """Max transmit amplitude per unit gradient: sqrt(d Es)/Gmax."""
    return float(np.sqrt(prm.d * prm.es) / prm.gmax)


def _linspace(start: torch.Tensor, stop: torch.Tensor, num: int) -> torch.Tensor:
    """jnp.linspace's f32 formula along a new last axis: start (1 - t) +
    stop t with t = arange(num - 1) / (num - 1), then the endpoint."""
    div = num - 1
    t = torch.arange(div, dtype=torch.float32, device=start.device) / div
    out = start[..., None] * (1 - t) + stop[..., None] * t
    return torch.cat([out, stop[..., None]], dim=-1)


# ---------------------------------------------------------------------------
# Truncated channel inversion (time-invariant gamma): SCA / LCPC / zero-bias.
# s_m = chi_m gamma_m / alpha,  noise = sqrt(N0)/alpha.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TruncatedInversion(PowerControl):
    thresholds: Optional[np.ndarray] = None   # [N] chi thresholds on |h|
    n0: float = 0.0
    noise_over_alpha: Optional[float] = None  # sqrt(n0)/alpha, float64

    def __post_init__(self):
        if self.noise_over_alpha is None and self.alpha is not None:
            self.noise_over_alpha = float(np.sqrt(self.n0) / self.alpha)

    def round_coeffs(self, h, coin):
        habs = torch.abs(h)
        dev = habs.device
        chi = (habs >= self.leaf("thresholds", dev)).to(habs.dtype)
        s = chi * self.leaf("gamma", dev) / self.leaf("alpha", dev)
        ns = self.leaf("noise_over_alpha", dev).expand(habs.shape[:-1])
        return s, ns


def _make_truncated(name: str, gamma: np.ndarray,
                    prm: OTAParams) -> TruncatedInversion:
    _, a, pm = theory.participation(gamma, prm)
    return TruncatedInversion(
        name=name, gamma=np.asarray(gamma, np.float64), alpha=a, p=pm,
        thresholds=theory.chi_threshold(gamma, prm), n0=prm.n0)


def make_sca(deployment: Deployment, prm: OTAParams,
             **kw) -> TruncatedInversion:
    """The paper's SCA design, solved by the scipy SLSQP loop
    (``core.sca.solve_sca``; the reference's ``method="scipy"``)."""
    return _make_truncated("sca", sca_mod.solve_sca(prm, **kw).gamma, prm)


def make_lcpc(deployment: Deployment, prm: OTAParams,
              grid_size: int = 512) -> TruncatedInversion:
    """Common pre-scaler, grid-optimized expected-MSE with statistical CSI."""
    gmax_arr = theory.gamma_max(prm)
    grid = np.geomspace(1e-3 * gmax_arr.min(), gmax_arr.max(), grid_size)
    best_g, best_v = None, np.inf
    n = prm.num_devices
    for g in grid:
        gamma = np.full(n, g)
        am = theory.alpha_of_gamma(gamma, prm)
        a = am.sum()
        if a <= 0:
            continue
        pm = am / a
        z = theory.zeta_terms(gamma, prm)
        # expected MSE proxy: variance + squared-bias (G^2-scaled; LCPC has no
        # access to the true dissimilarity kappa)
        v = z["total"] + prm.gmax**2 * n * np.sum((pm - 1.0 / n) ** 2)
        if v < best_v:
            best_g, best_v = g, v
    return _make_truncated("lcpc", np.full(n, best_g), prm)


def make_zero_bias(deployment: Deployment, prm: OTAParams,
                   slack: float = 1.0) -> TruncatedInversion:
    return _make_truncated("zero_bias", theory.zero_bias_gamma(prm, slack), prm)


# ---------------------------------------------------------------------------
# Vanilla OTA-FL: zero instantaneous bias; common scale c_t bound by the
# weakest instantaneous channel.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class VanillaOTA(PowerControl):
    bmax: float = 0.0
    n0: float = 0.0

    def round_coeffs(self, h, coin):
        habs = torch.abs(h)
        n = habs.shape[-1]
        c_t = self.leaf("bmax", habs.device) * torch.amin(habs, dim=-1)
        s = torch.full_like(habs, 1.0 / n)
        ns = torch.sqrt(self.leaf("n0", habs.device)) / (n * c_t)
        return s, ns


def make_vanilla(deployment: Deployment, prm: OTAParams) -> VanillaOTA:
    n = prm.num_devices
    return VanillaOTA(name="vanilla",
                      p=np.full(n, 1.0 / n), bmax=_bmax(prm), n0=prm.n0)


# ---------------------------------------------------------------------------
# OPC: per-round MSE-optimal amplitudes b_m = min(c/(N|h_m|), bmax) for a
# denoising scale c chosen on a log grid, then zoomed twice.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OPC(PowerControl):
    bmax: float = 0.0
    n0: float = 0.0
    gmax: float = 0.0
    grid_size: int = 128

    def round_coeffs(self, h, coin):
        habs = torch.abs(h)                         # [S, N]
        dev = habs.device
        n = habs.shape[-1]
        bmax, n0 = self.leaf("bmax", dev), self.leaf("n0", dev)
        gmax = self.leaf("gmax", dev)
        base = bmax * habs * n                      # c at which m leaves inversion
        c_lo = 0.02 * torch.amin(base, dim=-1)
        c_hi = 50.0 * torch.amax(base, dim=-1)
        grid = torch.exp(_linspace(torch.log(c_lo), torch.log(c_hi),
                                   self.grid_size))             # [S, G]

        def mse(c):                                 # c: [S, G] -> [S, G]
            b = torch.minimum(c[..., None] / (n * habs[:, None, :]), bmax)
            sig = torch.sum((b * habs[:, None, :] / c[..., None] - 1.0 / n)
                            ** 2, dim=-1) * gmax ** 2
            return sig + n0 / c ** 2

        def pick(cands):
            return torch.gather(cands, -1,
                                torch.argmin(mse(cands), dim=-1,
                                             keepdim=True))[..., 0]

        c_star = pick(grid)
        # torch.full, not torch.tensor: a host-to-device copy would
        # synchronize the stream every round
        offsets = torch.exp(_linspace(torch.full((), -0.15, device=dev),
                                      torch.full((), 0.15, device=dev), 33))
        for _ in range(2):                          # zoom around the optimum
            c_star = pick(c_star[..., None] * offsets)
        b = torch.minimum(c_star[..., None] / (n * habs), bmax)
        s = b * habs / c_star[..., None]
        return s, torch.sqrt(n0) / c_star


def make_opc(deployment: Deployment, prm: OTAParams) -> OPC:
    n = prm.num_devices
    return OPC(name="opc", p=np.full(n, 1.0 / n),
               bmax=_bmax(prm), n0=prm.n0, gmax=prm.gmax)


# ---------------------------------------------------------------------------
# BB-FL: interior scheduling within R_in, and the alternating variant.
# ---------------------------------------------------------------------------

def _bbfl_mask_coeffs(habs, mask, bmax, n0):
    k = torch.clamp(torch.sum(mask), min=1.0)
    c_t = bmax * torch.amin(torch.where(mask > 0, habs,
                                        torch.full_like(habs, float("inf"))),
                            dim=-1)
    s = (mask / k).expand(habs.shape)
    return s, torch.sqrt(n0) / (k * c_t)


@dataclasses.dataclass
class BBFL(PowerControl):
    mask: Optional[np.ndarray] = None    # [N] 1 if within R_in
    alternative: bool = False
    bmax: float = 0.0
    n0: float = 0.0

    def round_coeffs(self, h, coin):
        habs = torch.abs(h)
        dev = habs.device
        bmax, n0 = self.leaf("bmax", dev), self.leaf("n0", dev)
        interior = self.leaf("mask", dev)
        s_i, ns_i = _bbfl_mask_coeffs(habs, interior, bmax, n0)
        if not self.alternative:
            return s_i, ns_i
        s_f, ns_f = _bbfl_mask_coeffs(habs, torch.ones_like(interior), bmax, n0)
        use_full = coin.to(torch.bool)
        return (torch.where(use_full[:, None], s_f, s_i),
                torch.where(use_full, ns_f, ns_i))


def make_bbfl(deployment: Deployment, prm: OTAParams, alternative: bool,
              r_in_frac: float = 0.6) -> BBFL:
    r_in = r_in_frac * deployment.cfg.r_max
    mask = (deployment.distances <= r_in).astype(np.float64)
    if mask.sum() == 0:  # degenerate deployment: keep the closest device
        mask[np.argmin(deployment.distances)] = 1.0
    n = prm.num_devices
    name = "bbfl_alternative" if alternative else "bbfl_interior"
    # average participation: interior always on; alternative: 0.5 full + 0.5 interior
    k = mask.sum()
    p = (mask / k) if not alternative else 0.5 * (mask / k) + 0.5 / n
    return BBFL(name=name, p=p, mask=mask,
                alternative=alternative, bmax=_bmax(prm), n0=prm.n0)


# ---------------------------------------------------------------------------
# Ideal FedAvg: noiseless uniform aggregation (eq. (2)).
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Ideal(PowerControl):

    def round_coeffs(self, h, coin):
        habs = torch.abs(h)
        s = torch.full_like(habs, 1.0 / habs.shape[-1])
        return s, torch.zeros(habs.shape[:-1], dtype=habs.dtype,
                              device=habs.device)


def make_ideal(deployment: Deployment, prm: OTAParams) -> Ideal:
    n = prm.num_devices
    return Ideal(name="ideal", p=np.full(n, 1.0 / n))


# ---------------------------------------------------------------------------

SCHEMES = ("sca", "lcpc", "vanilla", "opc", "bbfl_interior",
           "bbfl_alternative", "ideal", "zero_bias")


def make_power_control(name: str, deployment: Deployment, prm: OTAParams,
                       **kw) -> PowerControl:
    if name == "sca":
        return make_sca(deployment, prm, **kw)
    if name == "lcpc":
        return make_lcpc(deployment, prm, **kw)
    if name == "vanilla":
        return make_vanilla(deployment, prm)
    if name == "opc":
        return make_opc(deployment, prm)
    if name == "bbfl_interior":
        return make_bbfl(deployment, prm, alternative=False, **kw)
    if name == "bbfl_alternative":
        return make_bbfl(deployment, prm, alternative=True, **kw)
    if name == "ideal":
        return make_ideal(deployment, prm)
    if name == "zero_bias":
        return make_zero_bias(deployment, prm, **kw)
    raise ValueError(f"unknown power-control scheme: {name!r}; "
                     f"available: {SCHEMES}")


def scheme_from_jax(name: str, fields: Mapping[str, np.ndarray]) -> PowerControl:
    """The port's scheme from a reference scheme's design leaves, given as a
    dict of numpy values (gamma, alpha, p, thresholds, noise_over_alpha,
    mask, bmax, n0, gmax -- whichever the scheme has).  Touches no JAX
    object: the caller pulls the fields off it."""
    def f(key, default=None):
        v = fields.get(key, default)
        return None if v is None else np.asarray(v, np.float64)

    common = dict(name=name, gamma=f("gamma"), p=f("p"))
    if name in ("sca", "lcpc", "zero_bias"):
        alpha = float(f("alpha"))
        return TruncatedInversion(
            **common, alpha=alpha,
            thresholds=f("thresholds"), n0=float(f("n0")),
            noise_over_alpha=float(f("noise_over_alpha")))
    if name == "vanilla":
        return VanillaOTA(**common,
                          bmax=float(f("bmax")), n0=float(f("n0")))
    if name == "opc":
        return OPC(**common, bmax=float(f("bmax")),
                   n0=float(f("n0")), gmax=float(f("gmax")),
                   grid_size=int(fields.get("grid_size", 128)))
    if name in ("bbfl_interior", "bbfl_alternative"):
        return BBFL(**common, mask=f("mask"),
                    alternative=name == "bbfl_alternative",
                    bmax=float(f("bmax")), n0=float(f("n0")))
    if name == "ideal":
        return Ideal(**common)
    raise ValueError(f"unknown power-control scheme: {name!r}; "
                     f"available: {SCHEMES}")
