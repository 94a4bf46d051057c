"""OTA power-control schemes: the paper's SCA design and the Fig.-2
baselines, ported from ``repro.core.power_control``.

Every scheme maps one round's complex fading ``h [S, N]`` (one row per
seed) and the ``bbfl_alternative`` coin ``[S]`` to

    (s [S, N], noise_scale [S])   with   g_hat = sum_m s_m g_m + noise_scale z

The designs are float64 numpy, built once on the host; the round
coefficients are computed in float32 from f32 copies of the design leaves,
as the reference does (its leaves enter the compiled round as f32 without
x64).  A design leaf may carry a leading seed axis ([S, N], [S]): an
adaptive scheme's design after its first redesign, one per seed row.

Global-CSI schemes become dropout-aware when the deployment's scenario
dynamics include device dropout (h = 0 rounds), so their channel-inversion
minima bind on the active devices only; the ``dropout_aware`` keyword
overrides.  A round in which every device dropped is a no-op for them
(s = 0, noise 0), never NaN.

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

Beyond the paper grid, ``adaptive_sca`` (``AdaptiveSCA``) re-solves the SCA
design between the fleet's chunks from the live Gauss-Markov fading state.
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
        alpha = self.leaf("alpha", dev)
        s = chi * self.leaf("gamma", dev) / alpha.reshape(
            alpha.shape + (1,) * (alpha.dim() > 0))
        ns = self.leaf("noise_over_alpha", dev).expand(habs.shape[:-1])
        return s, ns


def _make_truncated(name: str, gamma: np.ndarray,
                    prm: OTAParams) -> TruncatedInversion:
    _, a, pm = theory.participation(gamma, prm)
    return TruncatedInversion(
        name=name, gamma=np.asarray(gamma, np.float64), alpha=a, p=pm,
        thresholds=theory.chi_threshold(gamma, prm), n0=prm.n0)


def make_sca(deployment: Deployment, prm: OTAParams, method: str = "torch",
             **kw) -> TruncatedInversion:
    """The paper's SCA design.  ``method="torch"`` (default; ``"jax"`` is
    accepted as an alias, the reference's name for its default) runs the
    batched float64 solver (``repro_torch.solvers``) on ``device=``
    (default: the card); ``method="scipy"`` runs the host SLSQP oracle
    (``core.sca.solve_sca``).  The solve's ``SCAResult`` is attached as
    ``sca_result``."""
    if method == "scipy":
        res = sca_mod.solve_sca(prm, **kw)
    elif method in ("torch", "jax"):
        from repro_torch import solvers  # deferred: keep core light
        # the legacy solve_sca budget kwargs map onto SolverConfig
        legacy = {k: kw.pop(k) for k in ("max_iters", "tol", "backtracks")
                  if k in kw}
        cfg = kw.pop("cfg", solvers.DEFAULT_CONFIG)
        if legacy:
            cfg = dataclasses.replace(cfg, **legacy)
        res = solvers.solve(prm, cfg=cfg, **kw)
    else:
        raise ValueError(f"unknown sca method {method!r} (torch|jax|scipy)")
    pc = _make_truncated("sca", res.gamma, prm)
    pc.sca_result = res  # attach for inspection
    return pc


def make_sca_batch(prms, device=None) -> list:
    """The ``sca`` designs of several worlds from ONE batched solve
    (``solvers.solve_batch``, the default solver, on ``device``); the
    worlds share the fading family and device count.  Each design lands
    within the solver's tolerance of its own single solve."""
    from repro_torch import solvers
    prms = list(prms)
    res = solvers.solve_batch(prms, device=device)
    return [_make_truncated("sca", g, prm)
            for g, prm in zip(res.gamma, prms)]


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
# AdaptiveSCA: truncated inversion whose design re-solves during training,
# between the fleet's chunks, from the live Gauss-Markov fading state.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AdaptiveSCA(TruncatedInversion):
    """SCA design that tracks time-varying statistical CSI.

    Round coefficients are plain truncated inversion (inherited), so
    inside a chunk the scheme is ``sca``.  Between chunks the driver calls
    ``redesign_fn(scheme, fading, state)``: on a Gauss-Markov process it
    maps the scattered state d_t to the one-step conditional channel law
    (Rician: mean los + rho d_t, diffuse variance (1 - rho^2) Lambda_d),
    batch-solves (P1) under that CSI and returns the scheme with the new
    design, whose leaves take the state's leading axes.  On static CSI
    (no process, or rho = 0) it returns the scheme unchanged.

    ``redesign_cohort_fn(scheme, gains, device="cpu")`` is the
    population-mode sibling: it re-solves (P1) on an incoming cohort's
    STATIONARY statistical CSI (``gains`` [..., N], any leading batch
    axes; the family and its scalar parameter from the design's ``prm``)
    and returns the scheme with design leaves of those leading axes.  It
    is pure in ``gains`` -- no live fading state, no current design --
    which is what lets the driver stage it for the next cohort while the
    current chunk runs; ``device`` is where the f64 solver runs (the
    driver's staging lane: the host)."""
    redesign_fn: Optional[object] = None
    redesign_cohort_fn: Optional[object] = None


# K-factors above this are effectively deterministic channels; the cap keeps
# the conditional-CSI solve inside the Marcum-series accuracy envelope
# (solvers.theory._MARCUM_TERMS).
_ADAPTIVE_K_CAP = 50.0


def make_adaptive_sca(deployment: Deployment, prm: OTAParams,
                      **kw) -> AdaptiveSCA:
    """The adaptive scheme; its initial design is the static solve on the
    deployment's stationary CSI (``make_sca``'s default), or ``base``'s
    gamma when an ``sca`` design of this ``prm`` is handed in.  ``cfg``
    and ``device`` go to the solver; the redesign solves on the fading
    state's device.  When K adaptive schemes share a fleet, the first one's
    hook serves every row with its ``prm``'s constants, as the
    reference's; so does ``redesign_cohort_fn``."""
    from repro_torch import solvers
    cfg = kw.pop("cfg", solvers.DEFAULT_CONFIG)
    base = kw.pop("base", None)
    gamma = base.gamma if base is not None \
        else solvers.solve(prm, cfg=cfg, **kw).gamma
    b = _make_truncated("adaptive_sca", gamma, prm)

    def redesign(pc: AdaptiveSCA, fading, state):
        rho = float(getattr(fading, "rho", 0.0))
        if state is None or rho == 0.0:
            return pc      # static CSI: nothing to track
        n = prm.num_devices
        st = torch.as_tensor(state).to(torch.complex128)      # [..., N]
        dev, batch = st.device, tuple(st.shape[:-1])

        def f64(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=dev)
        diffuse = (1.0 - rho**2) * f64(fading._diffuse_gains())
        mean = f64(fading._los()) + rho * st     # one-step conditional mean
        nu2 = torch.abs(mean) ** 2
        gains_eff = (nu2 + diffuse).reshape(-1, n)             # [B, N]
        k_eff = torch.clamp(nu2 / diffuse, max=_ADAPTIVE_K_CAP).reshape(-1, n)
        rows = gains_eff.shape[0]

        def row(v):
            return f64(v).expand(rows)
        prm_b = solvers.SolverParams(
            d=row(prm.d), gmax=row(prm.gmax), es=row(prm.es),
            n0=row(prm.n0), gains=gains_eff,
            sigma_sq=f64(prm.sigma_sq).expand(rows, n), eta=row(prm.eta),
            lsmooth=row(prm.lsmooth), kappa_sq=row(prm.kappa_sq),
            dropout=row(prm.dropout), fading_param=k_eff, family="rician")
        out = solvers.solve_batch(prm_b, cfg, device=dev)
        gamma = out.gamma.reshape(batch + (n,))
        alpha = out.alpha.reshape(batch)
        return dataclasses.replace(
            pc, gamma=gamma, alpha=alpha, p=out.p.reshape(batch + (n,)),
            thresholds=np.asarray(theory.chi_threshold(gamma, prm)),
            noise_over_alpha=np.sqrt(prm.n0) / alpha, _f32={})

    # population cohorts: the same solver on the incoming cohort's
    # stationary gains (family from prm, scalar parameter)
    family = "rayleigh" if prm.is_rayleigh else prm.fading.family
    fparam = 1.0
    if family == "rician":
        fparam = float(np.asarray(prm.fading.rician_k))
    elif family == "nakagami":
        fparam = float(np.asarray(prm.fading.nakagami_m))

    def redesign_cohort(pc: AdaptiveSCA, gains, device="cpu"):
        n = prm.num_devices
        g = np.asarray(gains, np.float64)
        if g.shape[-1] != n:
            raise ValueError(f"cohort gains have {g.shape[-1]} devices but "
                             f"the design was built for {n}")
        batch = g.shape[:-1]
        rows = int(np.prod(batch, dtype=np.int64))

        def row(v):
            return torch.full((rows,), float(v), dtype=torch.float64)
        prm_b = solvers.SolverParams(
            d=row(prm.d), gmax=row(prm.gmax), es=row(prm.es),
            n0=row(prm.n0), gains=torch.as_tensor(g.reshape(rows, n)),
            sigma_sq=torch.as_tensor(np.broadcast_to(
                np.asarray(prm.sigma_sq, np.float64), (rows, n)).copy()),
            eta=row(prm.eta), lsmooth=row(prm.lsmooth),
            kappa_sq=row(prm.kappa_sq), dropout=row(prm.dropout),
            fading_param=torch.full((rows, n), fparam, dtype=torch.float64),
            family=family)
        out = solvers.solve_batch(prm_b, cfg, device=device)
        gamma = out.gamma.reshape(batch + (n,))
        alpha = out.alpha.reshape(batch)
        return dataclasses.replace(
            pc, gamma=gamma, alpha=alpha, p=out.p.reshape(batch + (n,)),
            thresholds=np.asarray(theory.chi_threshold(gamma, prm)),
            noise_over_alpha=np.sqrt(prm.n0) / alpha, _f32={})

    return AdaptiveSCA(
        name="adaptive_sca", gamma=b.gamma, alpha=b.alpha, p=b.p,
        thresholds=b.thresholds, n0=prm.n0,
        noise_over_alpha=b.noise_over_alpha, redesign_fn=redesign,
        redesign_cohort_fn=redesign_cohort)


# ---------------------------------------------------------------------------
# Vanilla OTA-FL: zero instantaneous bias; common scale c_t bound by the
# weakest instantaneous channel.
# ---------------------------------------------------------------------------

def _active_min(habs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """min over the last axis of |h| where ``mask``; inf where none."""
    return torch.amin(torch.where(mask, habs,
                                  torch.full_like(habs, float("inf"))),
                      dim=-1)


@dataclasses.dataclass
class VanillaOTA(PowerControl):
    bmax: float = 0.0
    n0: float = 0.0
    dropout_aware: bool = False   # scenarios with p_dropout > 0 observe h=0

    def round_coeffs(self, h, coin):
        habs = torch.abs(h)
        n = habs.shape[-1]
        bmax = self.leaf("bmax", habs.device)
        sqrt_n0 = torch.sqrt(self.leaf("n0", habs.device))
        if not self.dropout_aware:      # the paper baseline
            c_t = bmax * torch.amin(habs, dim=-1)
            s = torch.full_like(habs, 1.0 / n)
            return s, sqrt_n0 / (n * c_t)
        # dropped devices (h = 0) are left out of the inversion: the scale
        # binds on the weakest active channel, the active ones are averaged
        active = (habs > 0).to(habs.dtype)
        k = torch.clamp(torch.sum(active, dim=-1), min=1.0)
        c_t = bmax * _active_min(habs, habs > 0)
        return active / k[..., None], sqrt_n0 / (k * c_t)


def _dropout_aware(deployment: Deployment, override) -> bool:
    """Default the flag from the deployment's scenario dynamics, so schemes
    built on a dropout scenario never divide by an h = 0."""
    if override is not None:
        return bool(override)
    return getattr(deployment, "p_dropout", 0.0) > 0


def make_vanilla(deployment: Deployment, prm: OTAParams,
                 dropout_aware: Optional[bool] = None) -> VanillaOTA:
    n = prm.num_devices
    return VanillaOTA(name="vanilla",
                      p=np.full(n, 1.0 / n), bmax=_bmax(prm), n0=prm.n0,
                      dropout_aware=_dropout_aware(deployment, dropout_aware))


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
    dropout_aware: bool = False   # scenarios with p_dropout > 0 observe h=0

    def round_coeffs(self, h, coin):
        habs = torch.abs(h)                         # [S, N]
        dev = habs.device
        n = habs.shape[-1]
        bmax, n0 = self.leaf("bmax", dev), self.leaf("n0", dev)
        gmax = self.leaf("gmax", dev)
        base = bmax * habs * n                      # c at which m leaves inversion
        if self.dropout_aware:
            # dropped devices (base 0) transmit nothing; the grid's bounds
            # anchor on the active ones.  An all-dropped round takes a dummy
            # finite bracket, s is 0 there and its noise is zeroed below
            any_active = torch.any(base > 0, dim=-1)
            c_lo = torch.where(any_active, 0.02 * _active_min(base, base > 0),
                               torch.ones_like(base[..., 0]))
            c_hi = torch.where(any_active, 50.0 * torch.amax(base, dim=-1),
                               torch.full_like(base[..., 0], 2.0))
        else:
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
        ns = torch.sqrt(n0) / c_star
        if self.dropout_aware:
            ns = torch.where(any_active, ns, torch.zeros_like(ns))
        return s, ns


def make_opc(deployment: Deployment, prm: OTAParams,
             dropout_aware: Optional[bool] = None) -> OPC:
    n = prm.num_devices
    return OPC(name="opc", p=np.full(n, 1.0 / n),
               bmax=_bmax(prm), n0=prm.n0, gmax=prm.gmax,
               dropout_aware=_dropout_aware(deployment, dropout_aware))


# ---------------------------------------------------------------------------
# BB-FL: interior scheduling within R_in, and the alternating variant.
# ---------------------------------------------------------------------------

def _bbfl_mask_coeffs(habs, mask, bmax, n0, dropout_aware: bool):
    if dropout_aware:
        # scheduled devices that dropped out (h = 0) cannot transmit
        mask = mask * (habs > 0).to(habs.dtype)
    # make_bbfl schedules >= 1 device, so the clamp binds only when every
    # scheduled device dropped out (then c_t = inf: s = 0, noise 0)
    k = torch.clamp(torch.sum(mask, dim=-1), min=1.0)
    c_t = bmax * _active_min(habs, mask > 0)
    s = (mask / k[..., None]).expand(habs.shape)
    return s, torch.sqrt(n0) / (k * c_t)


@dataclasses.dataclass
class BBFL(PowerControl):
    mask: Optional[np.ndarray] = None    # [N] 1 if within R_in
    alternative: bool = False
    bmax: float = 0.0
    n0: float = 0.0
    dropout_aware: bool = False   # scenarios with p_dropout > 0 observe h=0

    def round_coeffs(self, h, coin):
        habs = torch.abs(h)
        dev = habs.device
        bmax, n0 = self.leaf("bmax", dev), self.leaf("n0", dev)
        interior = self.leaf("mask", dev)
        da = self.dropout_aware
        s_i, ns_i = _bbfl_mask_coeffs(habs, interior, bmax, n0, da)
        if not self.alternative:
            return s_i, ns_i
        s_f, ns_f = _bbfl_mask_coeffs(habs, torch.ones_like(interior), bmax,
                                      n0, da)
        use_full = coin.to(torch.bool)
        return (torch.where(use_full[:, None], s_f, s_i),
                torch.where(use_full, ns_f, ns_i))


def make_bbfl(deployment: Deployment, prm: OTAParams, alternative: bool,
              r_in_frac: float = 0.6,
              dropout_aware: Optional[bool] = None) -> BBFL:
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
                alternative=alternative, bmax=_bmax(prm), n0=prm.n0,
                dropout_aware=_dropout_aware(deployment, dropout_aware))


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
        return make_vanilla(deployment, prm, **kw)
    if name == "opc":
        return make_opc(deployment, prm, **kw)
    if name == "bbfl_interior":
        return make_bbfl(deployment, prm, alternative=False, **kw)
    if name == "bbfl_alternative":
        return make_bbfl(deployment, prm, alternative=True, **kw)
    if name == "ideal":
        return make_ideal(deployment, prm)
    if name == "zero_bias":
        return make_zero_bias(deployment, prm, **kw)
    if name == "adaptive_sca":
        return make_adaptive_sca(deployment, prm, **kw)
    raise ValueError(f"unknown power-control scheme: {name!r}; "
                     f"available: {SCHEMES + ('adaptive_sca',)}")


def scheme_from_jax(name: str, fields: Mapping[str, np.ndarray]) -> PowerControl:
    """The port's scheme from a reference scheme's design leaves, given as a
    dict of numpy values (gamma, alpha, p, thresholds, noise_over_alpha,
    mask, bmax, n0, gmax, dropout_aware -- whichever the scheme has).
    Touches no JAX object: the caller pulls the fields off it."""
    def f(key, default=None):
        v = fields.get(key, default)
        return None if v is None else np.asarray(v, np.float64)

    common = dict(name=name, gamma=f("gamma"), p=f("p"))
    da = bool(fields.get("dropout_aware", False))
    if name in ("sca", "lcpc", "zero_bias"):
        alpha = float(f("alpha"))
        return TruncatedInversion(
            **common, alpha=alpha,
            thresholds=f("thresholds"), n0=float(f("n0")),
            noise_over_alpha=float(f("noise_over_alpha")))
    if name == "vanilla":
        return VanillaOTA(**common, bmax=float(f("bmax")),
                          n0=float(f("n0")), dropout_aware=da)
    if name == "opc":
        return OPC(**common, bmax=float(f("bmax")),
                   n0=float(f("n0")), gmax=float(f("gmax")),
                   grid_size=int(fields.get("grid_size", 128)),
                   dropout_aware=da)
    if name in ("bbfl_interior", "bbfl_alternative"):
        return BBFL(**common, mask=f("mask"),
                    alternative=name == "bbfl_alternative",
                    bmax=float(f("bmax")), n0=float(f("n0")),
                    dropout_aware=da)
    if name == "ideal":
        return Ideal(**common)
    raise ValueError(f"unknown power-control scheme: {name!r}; "
                     f"available: {SCHEMES}")
