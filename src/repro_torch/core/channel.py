"""Wireless channel model for OTA-FL (paper §II), numpy only.

A copy of the part of ``repro.core.channel`` the port's power-control
designs need: the deployment (``deploy``, ``WirelessConfig``,
``Deployment``), the fading-family description (``FadingSpec``,
``RAYLEIGH``) and the magnitude survival function ``fading_magnitude_sf``.
Flat Rayleigh fading h_{m,t} ~ CN(0, Lambda_m), with Lambda_m from the
log-distance path-loss model of §IV:

    PL(dist)[dB] = PL0 + 10 * beta * log10(dist / d0)

with PL0 = 50 dB at d0 = 1 m and path-loss exponent beta = 2.2.  All
power-control math is float64 numpy; the training path consumes the
resulting per-round coefficients in float32.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

DEFAULT_PL0_DB = 50.0          # path loss at reference distance (dB)
DEFAULT_PL_EXPONENT = 2.2      # path loss exponent
DEFAULT_R_MAX = 1750.0         # deployment radius (m)
DEFAULT_BANDWIDTH = 1e6        # B = 1 MHz
DEFAULT_PTX_DBM = 0.0          # transmit power, 0 dBm
DEFAULT_N0_DBM_HZ = -173.0     # noise PSD at the PS, -173 dBm/Hz


def dbm_to_watt(dbm: float) -> float:
    return 10.0 ** (dbm / 10.0) * 1e-3


def path_loss_db(dist_m: np.ndarray, pl0_db: float = DEFAULT_PL0_DB,
                 exponent: float = DEFAULT_PL_EXPONENT) -> np.ndarray:
    """Log-distance path loss in dB at distance ``dist_m`` meters."""
    dist_m = np.asarray(dist_m, dtype=np.float64)
    return pl0_db + 10.0 * exponent * np.log10(np.maximum(dist_m, 1.0))


def average_gain(dist_m: np.ndarray, pl0_db: float = DEFAULT_PL0_DB,
                 exponent: float = DEFAULT_PL_EXPONENT) -> np.ndarray:
    """Lambda_m: linear average channel power gain."""
    return 10.0 ** (-path_loss_db(dist_m, pl0_db, exponent) / 10.0)


FADING_FAMILIES = ("rayleigh", "rician", "nakagami")


@dataclasses.dataclass(frozen=True)
class FadingSpec:
    """Small-scale fading family, normalized so E|h_m|^2 = Lambda_m.

    rayleigh    h ~ CN(0, Lambda)                       (paper baseline)
    rician      h = sqrt(K Lambda/(K+1)) + CN(0, Lambda/(K+1))
    nakagami    |h|^2 ~ Gamma(m, Lambda/m), uniform phase
    """
    family: str = "rayleigh"
    rician_k: object = 5.0       # K-factor (linear), scalar or [N]
    nakagami_m: object = 2.0     # shape m >= 0.5, scalar or [N]

    def __post_init__(self):
        if self.family not in FADING_FAMILIES:
            raise ValueError(f"unknown fading family {self.family!r}; "
                             f"available: {FADING_FAMILIES}")


RAYLEIGH = FadingSpec()


def _per_device(param, shape) -> np.ndarray:
    """Broadcast a scalar or per-device [N] parameter to ``shape``, where the
    leading axis of ``shape`` is the device axis."""
    p = np.asarray(param, dtype=np.float64)
    if p.ndim == 1 and len(shape) > 1 and p.shape[0] == shape[0]:
        p = p.reshape((shape[0],) + (1,) * (len(shape) - 1))
    return np.broadcast_to(p, shape)


def _rician_nu_sigma(gains: np.ndarray, k: np.ndarray):
    """Rice parameters: LOS amplitude nu and diffuse per-component std sigma."""
    nu = np.sqrt(gains * k / (k + 1.0))
    sigma = np.sqrt(gains / (2.0 * (k + 1.0)))
    return nu, sigma


@dataclasses.dataclass(frozen=True)
class WirelessConfig:
    """Statistical description of the heterogeneous wireless deployment
    (the statistical CSI {Lambda_m} the PS is allowed to know)."""
    num_devices: int = 10
    r_max: float = DEFAULT_R_MAX
    pl0_db: float = DEFAULT_PL0_DB
    pl_exponent: float = DEFAULT_PL_EXPONENT
    bandwidth_hz: float = DEFAULT_BANDWIDTH
    ptx_dbm: float = DEFAULT_PTX_DBM
    n0_dbm_hz: float = DEFAULT_N0_DBM_HZ
    seed: int = 0

    @property
    def ptx_watt(self) -> float:
        return dbm_to_watt(self.ptx_dbm)

    @property
    def energy_per_sample(self) -> float:
        """E_s: max per-sample (per-symbol) energy budget = Ptx / B [J]."""
        return self.ptx_watt / self.bandwidth_hz

    @property
    def noise_psd(self) -> float:
        """N0 in W/Hz == J (noise energy per symbol at unit bandwidth)."""
        return dbm_to_watt(self.n0_dbm_hz)


@dataclasses.dataclass(frozen=True)
class Deployment:
    """A realized device deployment: distances and average gains."""
    cfg: WirelessConfig
    distances: np.ndarray    # [N] meters
    gains: np.ndarray        # [N] Lambda_m (linear)

    @property
    def num_devices(self) -> int:
        return int(self.gains.shape[0])


def deploy(cfg: WirelessConfig, distances: Optional[np.ndarray] = None) -> Deployment:
    """Uniformly deploy ``cfg.num_devices`` devices in a disk of radius r_max.

    Area-uniform: r = r_max * sqrt(U).  Deterministic given cfg.seed.
    """
    if distances is None:
        rng = np.random.default_rng(cfg.seed)
        u = rng.uniform(size=cfg.num_devices)
        distances = cfg.r_max * np.sqrt(u)
        # Keep devices at least 1 m away from the PS (reference distance).
        distances = np.maximum(distances, 1.0)
    distances = np.asarray(distances, dtype=np.float64)
    gains = average_gain(distances, cfg.pl0_db, cfg.pl_exponent)
    return Deployment(cfg=cfg, distances=distances, gains=gains)


def fading_magnitude_sf(gains: np.ndarray, x: np.ndarray,
                        spec: Optional[FadingSpec] = None) -> np.ndarray:
    """Survival function P(|h_m| >= x) per device (broadcasts gains vs x).

      rayleigh   exp(-x^2 / L)
      rician     Marcum-Q_1(nu/sigma, x/sigma)         (scipy.stats.rice)
      nakagami   Gamma(m, m x^2 / L) / Gamma(m)        (regularized upper)
    """
    g0 = np.asarray(gains, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    if spec is None or spec.family == "rayleigh":
        return np.exp(-x**2 / g0)
    if spec.family == "rician":
        from scipy.stats import rice
        k = _per_device(spec.rician_k, g0.shape)
        gains, x, k = np.broadcast_arrays(g0, x, k)
        nu, sigma = _rician_nu_sigma(gains, k)
        return rice.sf(x / sigma, nu / sigma)
    if spec.family == "nakagami":
        from scipy.special import gammaincc
        m = _per_device(spec.nakagami_m, g0.shape)
        gains, x, m = np.broadcast_arrays(g0, x, m)
        return gammaincc(m, m * x**2 / gains)
    raise ValueError(f"unknown fading family {spec.family!r}")
