"""Scenario engine for heterogeneous wireless deployments, ported from
``repro.core.scenarios``, with its population layer.

A ``Scenario`` composes one choice per heterogeneity axis:

    geometry     where devices sit: uniform disk (baseline), annular ring,
                 two-cluster near/far, fixed-distance grid
    large-scale  log-distance path loss, optionally with log-normal
                 shadowing (ShadowingSpec, sigma in dB)
    small-scale  fading family: Rayleigh / Rician(K) / Nakagami-m
                 (channel.FadingSpec, per-device parameters allowed)
    dynamics     round-to-round behaviour: i.i.d. (baseline), Gauss-Markov
                 correlated fading (rho), round-level device dropout

``realize`` turns a Scenario into a ``channel.Deployment`` (numpy float64,
bitwise the reference's), which every power-control design consumes.
``make_fading_process`` builds the matching per-round sampler and
``stack_scenarios`` C of them as one ``ScenarioStack``, the channel of the
[scenario x scheme x seed] grid fleet.  ``Population`` is a lazily
materialized universe of up to ~1M devices from which a fleet in
population mode draws a cohort per chunk (numpy uint64 hashes and
``default_rng``, bitwise the reference's).

Randomness.  Torch cannot reproduce JAX's key streams, so the samplers take
a round's innovations (``ota.Innovations``: the scattered normals, the
dropout uniforms, Nakagami's Gamma inputs) and transform them; the fleet's
draws provider makes them per (seed, round) and shares them across
scenario rows and schemes, as the reference tiles one key over a seed's
cells.  The samplers' arithmetic is float32 on float32 copies of the
deployment's parameters, as the reference's (its float64 numpy parameters
enter the compiled round as float32); ``gm_scale = sqrt(1 - rho^2)`` is
computed in float64 on the host and rounded once, as there.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import channel, ota
from repro_torch.core.channel import (Deployment, FadingSpec, RAYLEIGH,
                                      WirelessConfig)
from repro_torch.core.theory import OTAParams

# ---------------------------------------------------------------------------
# Axis specs
# ---------------------------------------------------------------------------

GEOMETRIES = ("disk", "ring", "two_cluster", "grid")


@dataclasses.dataclass(frozen=True)
class GeometrySpec:
    """Deployment geometry.  Distances are in meters, relative to the PS.

    disk         area-uniform in [0, r_max] (identical sampling to
                 channel.deploy -- the paper baseline)
    ring         area-uniform in the annulus [r_min, r_max]
    two_cluster  near_frac of devices ~ N(near_center, cluster_spread),
                 the rest ~ N(far_center, cluster_spread)
    grid         deterministic distances: ``distances`` if given, else
                 linspace(max(r_min, 1), r_max, N)
    """
    kind: str = "disk"
    r_min: float = 0.0
    near_frac: float = 0.5
    near_center: float = 150.0
    far_center: float = 1600.0
    cluster_spread: float = 50.0
    distances: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        if self.kind not in GEOMETRIES:
            raise ValueError(f"unknown geometry {self.kind!r}; "
                             f"available: {GEOMETRIES}")


@dataclasses.dataclass(frozen=True)
class ShadowingSpec:
    """Log-normal shadowing on top of path loss: PL_dB += N(0, sigma_db^2)."""
    sigma_db: float = 8.0


@dataclasses.dataclass(frozen=True)
class DynamicsSpec:
    """Round-to-round channel dynamics.

    rho        Gauss-Markov correlation of the scattered component across
               rounds: d_t = rho d_{t-1} + sqrt(1-rho^2) w_t (stationary
               marginal preserved; rho=0 is the i.i.d. paper baseline).
               Supported for rayleigh/rician (Gaussian scattered part).
    p_dropout  probability a device drops out of a round entirely: its
               channel is observed as h=0, which every scheme maps to
               non-participation.
    """
    rho: float = 0.0
    p_dropout: float = 0.0

    def __post_init__(self):
        if not (0.0 <= self.rho < 1.0):
            raise ValueError("rho in [0, 1)")
        if not (0.0 <= self.p_dropout < 1.0):
            raise ValueError("p_dropout in [0, 1)")


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Composable (geometry x large-scale x small-scale x dynamics) spec."""
    name: str
    geometry: GeometrySpec = GeometrySpec()
    fading: FadingSpec = RAYLEIGH
    shadowing: Optional[ShadowingSpec] = None
    dynamics: DynamicsSpec = DynamicsSpec()
    wireless: WirelessConfig = WirelessConfig()
    description: str = ""

    def __post_init__(self):
        if self.fading.family == "nakagami" and self.dynamics.rho > 0:
            raise ValueError("Gauss-Markov dynamics need a Gaussian scattered "
                             "component (rayleigh/rician); nakagami has none")
        n = self.wireless.num_devices
        for pname in ("rician_k", "nakagami_m"):
            v = np.asarray(getattr(self.fading, pname), dtype=np.float64)
            if v.ndim > 0 and v.shape != (n,):
                raise ValueError(
                    f"per-device {pname} has shape {v.shape} but the "
                    f"scenario deploys {n} devices")

    def replace(self, **kw) -> "Scenario":
        return dataclasses.replace(self, **kw)

    @property
    def is_baseline(self) -> bool:
        """True iff this is the paper's disk-Rayleigh-iid family."""
        return (self.geometry.kind == "disk" and self.shadowing is None
                and self.fading.family == "rayleigh"
                and self.dynamics == DynamicsSpec())


# ---------------------------------------------------------------------------
# Realization: Scenario -> Deployment (numpy float64, the reference's draws)
# ---------------------------------------------------------------------------

def sample_distances(geom: GeometrySpec, cfg: WirelessConfig,
                     rng: np.random.Generator) -> np.ndarray:
    """Draw [N] device distances for the given geometry.  The disk branch
    consumes the rng stream exactly like channel.deploy, so the baseline
    scenario reproduces the paper deployment bit for bit."""
    n, r_max = cfg.num_devices, cfg.r_max
    if geom.kind == "disk":
        u = rng.uniform(size=n)
        dist = r_max * np.sqrt(u)
    elif geom.kind == "ring":
        u = rng.uniform(size=n)
        dist = np.sqrt(geom.r_min**2 + u * (r_max**2 - geom.r_min**2))
    elif geom.kind == "two_cluster":
        n_near = int(np.clip(round(geom.near_frac * n), 1, n - 1))
        centers = np.where(np.arange(n) < n_near, geom.near_center,
                           geom.far_center)
        dist = centers + rng.standard_normal(n) * geom.cluster_spread
        dist = np.minimum(dist, r_max)
    elif geom.kind == "grid":
        if geom.distances is not None:
            dist = np.asarray(geom.distances, dtype=np.float64)
            if dist.shape != (n,):
                raise ValueError(f"grid distances {dist.shape} != ({n},)")
        else:
            dist = np.linspace(max(geom.r_min, 1.0), r_max, n)
    else:  # unreachable: GeometrySpec validates kind
        raise ValueError(geom.kind)
    return np.maximum(np.asarray(dist, dtype=np.float64), 1.0)


def realize(scenario: Scenario, seed: Optional[int] = None) -> Deployment:
    """Sample a concrete Deployment: distances, (shadowed) gains, fading
    spec.  Deterministic given the wireless seed; ``seed`` overrides it."""
    cfg = scenario.wireless
    if seed is not None:
        cfg = dataclasses.replace(cfg, seed=seed)
    rng = np.random.default_rng(cfg.seed)
    distances = sample_distances(scenario.geometry, cfg, rng)
    gains = channel.average_gain(distances, cfg.pl0_db, cfg.pl_exponent)
    shadow_db = None
    if scenario.shadowing is not None and scenario.shadowing.sigma_db > 0:
        shadow_db = rng.normal(0.0, scenario.shadowing.sigma_db,
                               size=cfg.num_devices)
        gains = gains * 10.0 ** (-shadow_db / 10.0)
    return Deployment(cfg=cfg, distances=distances, gains=gains,
                      fading=scenario.fading, shadowing_db=shadow_db,
                      p_dropout=scenario.dynamics.p_dropout)


def make_ota_params(dep: Deployment, d: int, gmax: float,
                    sigma_sq: Optional[np.ndarray] = None,
                    **kw) -> OTAParams:
    """Family-aware OTAParams from a realized deployment (carries the
    scenario's fading spec and dropout rate into the statistical CSI)."""
    spec = dep.fading
    if spec is not None and spec.family == "rayleigh":
        spec = None   # keep the exact Rayleigh closed-form fast path
    if sigma_sq is None:
        sigma_sq = np.zeros(dep.num_devices)
    return OTAParams(d=d, gmax=gmax, es=dep.cfg.energy_per_sample,
                     n0=dep.cfg.noise_psd, gains=dep.gains,
                     sigma_sq=sigma_sq, fading=spec,
                     dropout=dep.p_dropout, **kw)


# ---------------------------------------------------------------------------
# Per-round fading process
# ---------------------------------------------------------------------------

def _f32(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32))


def _keep_threshold(p_dropout) -> np.ndarray:
    """A device stays in a round when its uniform u in [0, 1) is below
    1 - p (float64 on the host, rounded once): p = 0 keeps every device."""
    return (1.0 - np.asarray(p_dropout, np.float64)).astype(np.float32)


def _on(params: dict, cache: dict, device: torch.device) -> dict:
    key = str(device)
    if key not in cache:
        cache[key] = {k: v.to(device) for k, v in params.items()}
    return cache[key]


@dataclasses.dataclass
class FadingProcess:
    """Per-round sampler h_t for a realized deployment.

    ``init(innov) -> state`` and ``step(state, innov) -> (state, h)``;
    ``state`` is the scattered (Gauss-Markov) channel component, complex64
    [..., N], carried (unused) on the i.i.d. paths too.  Both broadcast over
    any leading axes of the innovations ([S, N] for a fleet's seed rows),
    so they also serve as the reference's batched forms (``init_batch``,
    ``step_batch``).  The transforms are those of a one-row
    ``ScenarioStack`` (``as_stack``), which is what a fleet steps.

    The i.i.d. Rayleigh process turns the innovations' normals into h with
    the ops of ``ota.draw_fading`` (plus a LOS of exactly 0), so a fleet on
    it is bitwise the fleet without a process (the paper's path).
    """
    gains: Optional[np.ndarray] = None        # [N] float64
    family: str = "rayleigh"
    k_factor: Optional[np.ndarray] = None     # [N] rician
    m: Optional[np.ndarray] = None            # [N] nakagami
    rho: float = 0.0
    p_dropout: float = 0.0
    _cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    @property
    def needs_dropout(self) -> bool:
        return self.p_dropout > 0.0

    @property
    def needs_nakagami(self) -> bool:
        return self.family == "nakagami"

    def _k(self) -> np.ndarray:
        return (np.asarray(self.k_factor, np.float64)
                if self.family == "rician" else np.zeros_like(self.gains))

    def as_stack(self) -> "ScenarioStack":
        """This process as a one-row ``ScenarioStack`` (states [1, ..., N])."""
        if "stack" not in self._cache:
            self._cache["stack"] = stack_processes([self], ("process",))
        return self._cache["stack"]

    def _diffuse_gains(self) -> np.ndarray:
        """The diffuse gains Lambda / (K + 1), float32 values as float64:
        the redesign's input, as the reference reads its float32 leaves."""
        g, k = np.float32(self.gains), np.float32(self._k())
        return (g / (k + np.float32(1.0))).astype(np.float64)

    def _los(self) -> np.ndarray:
        """The LOS amplitude sqrt(Lambda K / (K + 1)), float32 as float64."""
        return ota.fading_scales(self.gains, self._k())[1].astype(np.float64)

    def init(self, innov: ota.Innovations) -> torch.Tensor:
        """Stationary scattered-component draw (the Markov state)."""
        return self.as_stack().init_grid(innov)[0]

    def step(self, state: Optional[torch.Tensor], innov: ota.Innovations):
        state, h = self.as_stack().step(
            None if state is None else state[None], innov)
        return (None if state is None else state[0]), h[0]

    def cohort_stack(self, n: int) -> "ScenarioStack":
        """This process over cohorts of ``n`` devices whose gains change
        from cohort to cohort (a population's, ``gains=None``): a one-row
        stack whose per-device parameters come with every step as operands
        (``cohort_operands``), never cached."""
        key = ("cohort", int(n))
        if key not in self._cache:
            def per_device(v, fill):
                return np.broadcast_to(np.asarray(
                    fill if v is None else v, np.float64), (n,)).copy()
            proc = dataclasses.replace(
                self, gains=np.ones(n), _cache={},
                k_factor=per_device(self.k_factor, 0.0)
                if self.family == "rician" else None,
                m=per_device(self.m, 1.0)
                if self.family == "nakagami" else None)
            self._cache[key] = stack_processes([proc], ("cohort",))
        return self._cache[key]

    def cohort_operands(self, gains) -> dict:
        """A cohort's per-device parameters, float32 numpy [..., N] made on
        the host from its gains [..., N] as the stack makes its own:
        ``gains``, ``scale`` and ``los`` (``ota.fading_scales``)."""
        g = np.asarray(gains, np.float64)
        k = None if self.family != "rician" \
            else np.broadcast_to(np.asarray(self.k_factor, np.float64),
                                 g.shape)
        scale, los = ota.fading_scales(g, k)
        return {"gains": g.astype(np.float32), "scale": scale, "los": los}

    def describe(self) -> str:
        return (f"FadingProcess(family={self.family},rho={float(self.rho)}"
                f",p_dropout={float(self.p_dropout)})")


# ---------------------------------------------------------------------------
# Scenario stacks: C fading processes as one set of [C, ...] tensors, the
# channel of the [C x K x S] grid fleet.  The reference dispatches each row
# through a lax.switch over seven kinds; here each kind's transform runs on
# every row and masks select the row's kind.  Rows of a family that does not
# use a parameter hold fillers (K = 0, m = 1, p = 0) that keep the dead
# values finite and make the live arithmetic bitwise the row's own process
# (Lambda / (0 + 1) and sqrt(Lambda 0 / 1) are exact; u < 1 - 0 keeps every
# device).
# ---------------------------------------------------------------------------

_SK_IID_RAYLEIGH, _SK_IID_RICIAN, _SK_IID_NAKAGAMI = 0, 1, 2
_SK_MARKOV = 3                       # rho > 0 (rayleigh/rician via K-factor)
_SK_DROP_RAYLEIGH, _SK_DROP_RICIAN, _SK_DROP_NAKAGAMI = 4, 5, 6

_FAMILY_INDEX = {"rayleigh": 0, "rician": 1, "nakagami": 2}
_NAKAGAMI_KINDS = (_SK_IID_NAKAGAMI, _SK_DROP_NAKAGAMI)


@dataclasses.dataclass
class ScenarioStack:
    """C stacked fading processes for the scenario-axis grid fleet: gains
    [C, N], per-device fading parameters [C, N] (fillers K = 0, m = 1),
    dynamics [C]; ``kind`` [C] is each row's sampler (the reference's
    seven).  ``init_grid`` and ``step`` work on states [C, ..., N] from
    innovations [..., N] shared by the rows; row c of ``step`` is bitwise
    what scenario c's standalone ``FadingProcess`` gives on the same
    innovations."""
    names: tuple = ()
    num_devices: int = 0
    gains: Optional[np.ndarray] = None       # [C, N] float64
    kind: Optional[np.ndarray] = None        # [C] int32
    k_factor: Optional[np.ndarray] = None    # [C, N] (0 filler)
    m: Optional[np.ndarray] = None           # [C, N] (1 filler)
    rho: Optional[np.ndarray] = None         # [C]
    gm_scale: Optional[np.ndarray] = None    # [C] sqrt(1 - rho^2), float64
    p_dropout: Optional[np.ndarray] = None   # [C]
    _cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                     compare=False)

    def __len__(self):
        return len(self.names)

    @property
    def needs_dropout(self) -> bool:
        return bool(np.any(np.asarray(self.p_dropout) > 0))

    @property
    def needs_nakagami(self) -> bool:
        return bool(np.isin(self.kind, _NAKAGAMI_KINDS).any())

    @property
    def needs_markov(self) -> bool:
        return bool(np.any(np.asarray(self.kind) == _SK_MARKOV))

    def _params(self, device: torch.device, lead: int) -> dict:
        """The rows' parameters on ``device``, per device [C, 1.., N] and
        per row [C, 1.., 1], with ``lead`` unit axes for the innovations'
        leading axes."""
        if not self._cache:
            scale, los = map(torch.as_tensor,
                             ota.fading_scales(self.gains, self.k_factor))
            kind = np.asarray(self.kind)
            self._cache["cpu"] = {
                "gains": _f32(self.gains), "scale": scale, "los": los,
                "m": _f32(self.m),
                "rho": _f32(self.rho), "gm": _f32(self.gm_scale),
                "keep": torch.as_tensor(_keep_threshold(self.p_dropout)),
                "markov": torch.as_tensor(kind == _SK_MARKOV),
                "nakagami": torch.as_tensor(np.isin(kind, _NAKAGAMI_KINDS))}
        return {k: v.reshape(v.shape[:1] + (1,) * (lead + 2 - v.dim())
                             + v.shape[1:])
                for k, v in _on(self._cache["cpu"], self._cache,
                                device).items()}

    def init_grid(self, innov: ota.Innovations) -> torch.Tensor:
        """[C, ..., N] initial states from the init innovations [..., N]
        (per seed): row c is scenario c's standalone ``FadingProcess.init``."""
        p = self._params(innov.n_re.device, innov.n_re.dim() - 1)
        return ota.gaussian_fading(innov.n_re, innov.n_im, p["scale"])

    def step(self, state: Optional[torch.Tensor], innov: ota.Innovations,
             cohort: Optional[dict] = None):
        """One round for every row: states [C, ..., N] (None if no row is
        Gauss-Markov), innovations [..., N]; returns (states, h [C, ...,
        N]).  ``cohort`` (a one-row stack's, ``FadingProcess.cohort_stack``)
        holds the devices' ``gains``, ``scale`` and ``los`` as tensors
        [..., N] in place of the stack's own: with the stack's values it
        is bitwise the plain step (the reference's ``step_cohort``)."""
        p = self._params(innov.n_re.device, innov.n_re.dim() - 1)
        if cohort is not None:
            p = dict(p, **{k: cohort[k][None]
                           for k in ("gains", "scale", "los")})
        w_re, w_im = innov.n_re * p["scale"], innov.n_im * p["scale"]
        h = torch.complex(p["los"] + w_re, w_im)               # i.i.d. rows
        if self.needs_markov:
            st_re = p["rho"] * state.real + p["gm"] * w_re
            st_im = p["rho"] * state.imag + p["gm"] * w_im
            state = torch.where(p["markov"], torch.complex(st_re, st_im),
                                state)
            h = torch.where(p["markov"],
                            torch.complex(p["los"] + st_re, st_im), h)
        if self.needs_nakagami:
            g = ota.gamma_variates(p["m"], innov.gamma_n, innov.gamma_u,
                                   innov.boost_u)
            h = torch.where(p["nakagami"],
                            ota.nakagami_fading(p["gains"], p["m"], g,
                                                innov.phase_u), h)
        if self.needs_dropout:
            h = torch.where(innov.drop_u < p["keep"], h, torch.zeros_like(h))
        return state, h

    def describe(self) -> str:
        """Stable identity string for fleet checkpoints (the reference's
        digest): a resume against another scenario axis is refused."""
        h = hashlib.sha1()
        for leaf in (self.gains, self.kind, self.k_factor, self.m,
                     self.rho, self.p_dropout):
            a = np.ascontiguousarray(np.asarray(leaf))
            h.update(str(a.dtype).encode())
            h.update(a.tobytes())
        return (f"scenarios[{','.join(self.names)};n={self.num_devices};"
                f"{h.hexdigest()[:12]}]")


def stack_processes(procs, names) -> ScenarioStack:
    """Stack C fading processes of one device count into a
    :class:`ScenarioStack`, row c named ``names[c]``."""
    procs, names = list(procs), tuple(names)
    if not procs:
        raise ValueError("a scenario stack needs at least one row")
    c = len(procs)
    if len(names) != c:
        raise ValueError(f"{c} deployments but {len(names)} names")
    n = int(np.shape(procs[0].gains)[-1])
    if any(int(np.shape(fp.gains)[-1]) != n for fp in procs):
        raise ValueError("deployments disagree on device count")
    kind = np.zeros(c, np.int32)
    m = np.ones((c, n), np.float64)
    for i, fp in enumerate(procs):
        if fp.family == "nakagami":
            m[i] = fp.m
        if fp.rho > 0:
            kind[i] = _SK_MARKOV
        elif fp.p_dropout > 0:
            kind[i] = _SK_DROP_RAYLEIGH + _FAMILY_INDEX[fp.family]
        else:
            kind[i] = _FAMILY_INDEX[fp.family]
    rho = np.asarray([fp.rho for fp in procs], np.float64)
    return ScenarioStack(
        names=names, num_devices=n,
        gains=np.stack([np.asarray(fp.gains, np.float64) for fp in procs]),
        kind=kind, k_factor=np.stack([np.broadcast_to(fp._k(), (n,))
                                      for fp in procs]), m=m,
        rho=rho, gm_scale=np.sqrt(1.0 - rho**2),
        p_dropout=np.asarray([fp.p_dropout for fp in procs], np.float64))


def stack_deployments(deps, dynamics=None, names=None) -> ScenarioStack:
    """Stack C realized Deployments (+ per-scenario DynamicsSpec) into one
    :class:`ScenarioStack`: row c is ``make_fading_process(deps[c],
    dynamics[c])``.  All deployments must agree on the device count (the
    grid shares one task partition)."""
    deps = list(deps)
    c = len(deps)
    dyns = list(dynamics) if dynamics is not None else [DynamicsSpec()] * c
    if len(dyns) != c:
        raise ValueError(f"{c} deployments but {len(dyns)} dynamics specs")
    names = tuple(names) if names is not None \
        else tuple(f"scenario{i}" for i in range(c))
    if len(names) != c:
        raise ValueError(f"{c} deployments but {len(names)} names")
    if any(d.num_devices != deps[0].num_devices for d in deps):
        raise ValueError("deployments disagree on device count")
    return stack_processes([make_fading_process(d, y)
                            for d, y in zip(deps, dyns)], names)


def stack_scenarios(scenarios, seed: Optional[int] = None) -> ScenarioStack:
    """Realize + stack scenarios (names or Scenario objects) for the grid
    fleet: ``run_fleet(..., scenarios=stack_scenarios(SWEEP_FAMILIES))``."""
    scs = [get_scenario(s) if isinstance(s, str) else s for s in scenarios]
    deps = [realize(sc, seed=seed) for sc in scs]
    return stack_deployments(deps, [sc.dynamics for sc in scs],
                             names=[sc.name for sc in scs])


def make_fading_process(dep: Deployment,
                        dynamics: Optional[DynamicsSpec] = None
                        ) -> FadingProcess:
    """The sampler matching a deployment's fading spec."""
    spec = dep.fading_spec
    dyn = dynamics if dynamics is not None else DynamicsSpec()
    if spec.family == "nakagami" and dyn.rho > 0:
        raise ValueError("Gauss-Markov dynamics unsupported for nakagami")
    n = dep.num_devices
    k_factor = m = None
    if spec.family == "rician":
        k_factor = np.broadcast_to(np.asarray(spec.rician_k, np.float64),
                                   (n,)).copy()
    if spec.family == "nakagami":
        m = np.broadcast_to(np.asarray(spec.nakagami_m, np.float64),
                            (n,)).copy()
    return FadingProcess(gains=np.asarray(dep.gains, np.float64),
                         family=spec.family, k_factor=k_factor, m=m,
                         rho=dyn.rho, p_dropout=dyn.p_dropout)


def scenario_fading_process(scenario: Scenario,
                            dep: Optional[Deployment] = None) -> FadingProcess:
    if dep is None:
        dep = realize(scenario)
    return make_fading_process(dep, scenario.dynamics)


# ---------------------------------------------------------------------------
# Population layer: a parametric device universe of up to ~1M devices,
# materialized lazily per cohort draw.  Per-device large-scale parameters
# are pure counter-based hashes of (population seed, device index), so
# nothing is stored per device until a cohort indexes in; cohort draws are
# pure functions of (population seed, run seed, tick), so a resumed stream
# redraws identical cohorts without any RNG cursor.  numpy throughout:
# bitwise the reference's.
# ---------------------------------------------------------------------------

_COHORT_SALT = 0xC040  # draw_cohort rng lane
_AGE_SALT = 0xA6ED     # stage_states innovation lane

# hash lanes per derived per-device quantity (normals consume lane, lane+1)
_LANE_GEOM, _LANE_CLUSTER, _LANE_SHADOW = 0, 1, 2
_LANE_TRAFFIC, _LANE_SPREAD = 4, 6


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer: well-mixed uint64 from uint64."""
    x = np.asarray(x, np.uint64)
    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _hash_u01(seed: int, idx: np.ndarray, lane: int) -> np.ndarray:
    """Uniform(0, 1) doubles, a pure function of (seed, device idx, lane)."""
    x = np.asarray(idx, np.uint64)
    with np.errstate(over="ignore"):
        x = x * np.uint64(0xD1342543DE82EF95)
        x = x ^ (np.uint64(seed & 0xFFFFFFFFFFFFFFFF)
                 * np.uint64(0x9E3779B97F4A7C15))
        x = x + np.uint64(lane) * np.uint64(0xBF58476D1CE4E5B9)
    x = _splitmix64(_splitmix64(x))
    return (x >> np.uint64(11)).astype(np.float64) * 2.0 ** -53


def _hash_normal(seed: int, idx: np.ndarray, lane: int) -> np.ndarray:
    """Standard normals via Box-Muller on lanes (lane, lane + 1)."""
    u1 = np.maximum(_hash_u01(seed, idx, lane), 2.0 ** -53)
    u2 = _hash_u01(seed, idx, lane + 1)
    return np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)


SAMPLINGS = ("uniform", "traffic")


@dataclasses.dataclass(frozen=True)
class PopulationSpec:
    """A parametric device population: the Scenario axes minus per-device
    realization, plus a sampling model for cohort draws.

    sampling       "uniform" -- every device equally likely per round;
                   "traffic" -- arrival-weighted: device weights are
                   log-normal(0, traffic_sigma^2) (heavy-tailed activity,
                   the Gumbel-top-k draw in ``Population.draw_cohort``).
    seed           the population's own seed: all per-device hashes and
                   cohort draws derive from it (independent of run seeds).
    """
    size: int = 1_000_000
    geometry: GeometrySpec = GeometrySpec()
    shadowing: Optional[ShadowingSpec] = None
    fading: FadingSpec = RAYLEIGH
    dynamics: DynamicsSpec = DynamicsSpec()
    wireless: WirelessConfig = WirelessConfig()
    sampling: str = "uniform"
    traffic_sigma: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.size <= 0:
            raise ValueError("population size must be positive")
        if self.sampling not in SAMPLINGS:
            raise ValueError(f"unknown sampling {self.sampling!r}; "
                             f"available: {SAMPLINGS}")
        for pname in ("rician_k", "nakagami_m"):
            if np.asarray(getattr(self.fading, pname)).ndim > 0:
                raise ValueError(
                    f"parametric populations need a scalar {pname} (per-"
                    f"device arrays cannot be materialized lazily)")


@dataclasses.dataclass
class Population:
    """Lazily materialized device population.

    Two flavours share one interface:

    * parametric -- built from a :class:`PopulationSpec`; ``gains_of(idx)``
      hashes (seed, idx) into geometry/shadowing and is O(len(idx)),
      whatever ``size`` says, so 1M devices cost nothing until drawn;
    * tabular -- explicit [P] gains (``from_deployment``), the anchor for
      the cohort == population bitwise-equivalence contract.

    ``draw_cohort(n, tick, seed)`` is a pure function of its arguments
    (counter-based ``np.random.default_rng`` keying; Gumbel-top-k without
    replacement under traffic weighting), so streaming resume re-derives
    every draw instead of checkpointing an RNG cursor.  The Gauss-Markov
    re-entry table (``init_table`` / ``stage_states`` / ``commit_states``)
    ages a returning device's scattered state by its absence:
    d = rho^m d0 + sqrt(1 - rho^(2m)) w over m missed rounds -- m = 0 is an
    exact pass-through (back-to-back cohorts keep their trajectory) and a
    never-seen device gets a fresh stationary draw.
    """
    spec: Optional[PopulationSpec] = None
    gains_table: Optional[np.ndarray] = None      # [P] tabular gains
    weights_table: Optional[np.ndarray] = None    # [P] tabular weights
    fading: FadingSpec = RAYLEIGH
    dynamics: DynamicsSpec = DynamicsSpec()
    seed: int = 0
    name: str = "population"

    def __post_init__(self):
        if (self.spec is None) == (self.gains_table is None):
            raise ValueError("exactly one of spec / gains_table required")
        if self.spec is not None:
            self.fading = self.spec.fading
            self.dynamics = self.spec.dynamics
            self.seed = self.spec.seed
        else:
            self.gains_table = np.asarray(self.gains_table, np.float64)
            for pname in ("rician_k", "nakagami_m"):
                if np.asarray(getattr(self.fading, pname)).ndim > 0:
                    raise ValueError(f"populations need a scalar {pname}")
        if self.fading.family == "nakagami" and self.dynamics.rho > 0:
            raise ValueError("Gauss-Markov dynamics unsupported for nakagami")
        self._weights = None

    @classmethod
    def from_deployment(cls, dep: Deployment,
                        dynamics: Optional[DynamicsSpec] = None,
                        weights: Optional[np.ndarray] = None) -> "Population":
        """Wrap a realized Deployment as a (tabular) population -- with
        cohort_size == dep.num_devices this reproduces the full-
        participation fleet bitwise."""
        return cls(gains_table=np.asarray(dep.gains, np.float64),
                   weights_table=weights, fading=dep.fading_spec,
                   dynamics=(dynamics if dynamics is not None
                             else DynamicsSpec(p_dropout=dep.p_dropout)),
                   name=f"deployment[{dep.num_devices}]")

    @property
    def size(self) -> int:
        return (self.spec.size if self.spec is not None
                else int(self.gains_table.shape[0]))

    # -- lazy per-device parameters -------------------------------------

    def distances_of(self, idx: np.ndarray) -> np.ndarray:
        """Parametric geometry at device indices (hash-derived)."""
        if self.spec is None:
            raise ValueError("tabular populations have no geometry")
        geom, cfg, p = self.spec.geometry, self.spec.wireless, self.size
        idx = np.asarray(idx, np.int64)
        u = _hash_u01(self.seed, idx, _LANE_GEOM)
        if geom.kind == "disk":
            dist = cfg.r_max * np.sqrt(u)
        elif geom.kind == "ring":
            dist = np.sqrt(geom.r_min**2 + u * (cfg.r_max**2 - geom.r_min**2))
        elif geom.kind == "two_cluster":
            near = _hash_u01(self.seed, idx, _LANE_CLUSTER) < geom.near_frac
            centers = np.where(near, geom.near_center, geom.far_center)
            dist = centers + (_hash_normal(self.seed, idx, _LANE_SPREAD)
                              * geom.cluster_spread)
            dist = np.minimum(dist, cfg.r_max)
        else:  # grid: deterministic linspace over the whole population
            lo = max(geom.r_min, 1.0)
            dist = lo + idx * (cfg.r_max - lo) / max(p - 1, 1)
        return np.maximum(dist, 1.0)

    def gains_of(self, idx: np.ndarray) -> np.ndarray:
        """Average channel gains at device indices, [len(idx)] float64."""
        idx = np.asarray(idx, np.int64)
        if self.spec is None:
            return self.gains_table[idx]
        cfg = self.spec.wireless
        gains = channel.average_gain(self.distances_of(idx), cfg.pl0_db,
                                     cfg.pl_exponent)
        if self.spec.shadowing is not None \
                and self.spec.shadowing.sigma_db > 0:
            db = (_hash_normal(self.seed, idx, _LANE_SHADOW)
                  * self.spec.shadowing.sigma_db)
            gains = gains * 10.0 ** (-db / 10.0)
        return gains

    def weights(self) -> Optional[np.ndarray]:
        """[P] sampling weights (None = uniform).  Materialized once and
        cached -- the only O(P) array a parametric population ever builds."""
        if self.spec is not None and self.spec.sampling == "uniform":
            return None
        if self._weights is None:
            if self.spec is not None:
                z = _hash_normal(self.seed,
                                 np.arange(self.size, dtype=np.int64),
                                 _LANE_TRAFFIC)
                self._weights = np.exp(self.spec.traffic_sigma * z)
            else:
                self._weights = (None if self.weights_table is None
                                 else np.asarray(self.weights_table,
                                                 np.float64))
        return self._weights

    # -- cohort draws ----------------------------------------------------

    def draw_cohort(self, n: int, tick: int, seed: int = 0) -> np.ndarray:
        """Sorted [n] device indices for cohort ``tick`` of run ``seed``.

        Pure in (population seed, seed, tick): counter-based rng keying, no
        mutable stream -- a resumed driver re-derives any draw.  n == size
        returns arange (the full-participation identity path).  Weighted
        sampling is Gumbel-top-k on log-weights -- exact sampling without
        replacement proportional to weights at each slot.
        """
        p = self.size
        if not 0 < n <= p:
            raise ValueError(f"cohort size {n} not in [1, {p}]")
        if n == p:
            return np.arange(p, dtype=np.int64)
        rng = np.random.default_rng(
            (self.seed, int(seed), int(tick), _COHORT_SALT))
        w = self.weights()
        if w is None:
            idx = rng.choice(p, size=n, replace=False)
        else:
            keys = np.log(w) + rng.gumbel(size=p)
            idx = np.argpartition(keys, p - n)[p - n:]
        return np.sort(idx.astype(np.int64))

    # -- Gauss-Markov re-entry state ------------------------------------

    def init_table(self, num_rows: int) -> dict:
        """Host-side per-(seed-row, device) fading memory: round last seen
        (-1 = never) and the scattered state as of that round."""
        return {"last": np.full((num_rows, self.size), -1, np.int64),
                "state": np.zeros((num_rows, self.size), np.complex64)}

    def stage_states(self, table: dict, row: int, idx: np.ndarray, t0: int,
                     seed: int = 0) -> np.ndarray:
        """Scattered states for cohort ``idx`` entering at round ``t0``,
        aged from the table by each device's absence (see class docstring).
        Pure in (table contents, row, idx, t0, seed) -- recomputed
        identically on resume.  [len(idx)] complex64."""
        rho = float(self.dynamics.rho)
        idx = np.asarray(idx, np.int64)
        last = table["last"][row, idx]
        old = table["state"][row, idx].astype(np.complex128)
        missed = np.maximum(t0 - 1 - last, 0)
        decay = np.where(last < 0, 0.0,
                         rho ** missed if rho > 0.0 else (missed == 0))
        rng = np.random.default_rng(
            (self.seed, int(seed), int(t0), _AGE_SALT))
        z = rng.standard_normal((2, idx.shape[0]))
        k = float(np.asarray(self.fading.rician_k)) \
            if self.fading.family == "rician" else 0.0
        diffuse = self.gains_of(idx) / (k + 1.0)
        w = (z[0] + 1j * z[1]) * np.sqrt(diffuse / 2.0)
        state = decay * old + np.sqrt(np.maximum(1.0 - decay**2, 0.0)) * w
        return state.astype(np.complex64)

    def commit_states(self, table: dict, row: int, idx: np.ndarray,
                      t_end: int, state: np.ndarray) -> None:
        """Write a finished chunk's final states back: cohort ``idx`` was
        last seen at round ``t_end`` with scattered state ``state``."""
        idx = np.asarray(idx, np.int64)
        table["last"][row, idx] = int(t_end)
        table["state"][row, idx] = np.asarray(state, np.complex64)

    # -- glue ------------------------------------------------------------

    def fading_process(self) -> Optional[FadingProcess]:
        """The cohort-run per-round sampler (its ``cohort_stack`` steps on
        the staged cohort's gains); None when the population is the paper's
        i.i.d.-Rayleigh baseline -- the fleet's fading=None fast path,
        which is what the bitwise full-participation contract pins."""
        dyn = self.dynamics
        if self.fading.family == "rayleigh" and dyn == DynamicsSpec():
            return None
        k_factor = m = None
        if self.fading.family == "rician":
            k_factor = np.asarray(float(np.asarray(self.fading.rician_k)))
        if self.fading.family == "nakagami":
            m = np.asarray(float(np.asarray(self.fading.nakagami_m)))
        return FadingProcess(gains=None, family=self.fading.family,
                             k_factor=k_factor, m=m, rho=dyn.rho,
                             p_dropout=dyn.p_dropout)

    def describe(self) -> str:
        """Stable identity string for fleet checkpoints (a resume against
        a different population must be rejected, not silently mixed)."""
        dyn = self.dynamics
        tail = (f"fading={self.fading.family},rho={dyn.rho}"
                f",drop={dyn.p_dropout},seed={self.seed}")
        if self.spec is not None:
            sp = self.spec
            return (f"pop(size={sp.size},geom={sp.geometry.kind},"
                    f"shadow={sp.shadowing is not None},"
                    f"sampling={sp.sampling},sigma={sp.traffic_sigma},{tail})")
        h = hashlib.sha1(self.gains_table.tobytes()).hexdigest()[:12]
        w = self.weights()
        wh = "none" if w is None else hashlib.sha1(w.tobytes()).hexdigest()[:12]
        return f"pop(table={h},weights={wh},{tail})"


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Scenario] = {}


def register_scenario(sc: Scenario, overwrite: bool = False) -> Scenario:
    if sc.name in _REGISTRY and not overwrite:
        raise ValueError(f"scenario {sc.name!r} already registered")
    _REGISTRY[sc.name] = sc
    return sc


def get_scenario(name: str) -> Scenario:
    if name not in _REGISTRY:
        raise ValueError(f"unknown scenario {name!r}; "
                         f"available: {scenario_names()}")
    return _REGISTRY[name]


def scenario_names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


register_scenario(Scenario(
    name="disk_rayleigh",
    description="Paper baseline: area-uniform disk, log-distance path loss, "
                "i.i.d. Rayleigh (bit-identical to channel.deploy)."))

register_scenario(Scenario(
    name="disk_rician",
    fading=FadingSpec(family="rician", rician_k=5.0),
    description="Disk deployment with LOS-rich Rician fading, K = 5."))

register_scenario(Scenario(
    name="disk_rician_mixed",
    fading=FadingSpec(family="rician",
                      rician_k=(10.0, 10.0, 10.0, 10.0, 10.0,
                                0.5, 0.5, 0.5, 0.5, 0.5)),
    description="Per-device K-factor: half the fleet near-LOS (K=10), half "
                "heavily scattered (K=0.5)."))

register_scenario(Scenario(
    name="disk_nakagami",
    fading=FadingSpec(family="nakagami", nakagami_m=2.0),
    description="Disk deployment with milder-than-Rayleigh Nakagami-2 fading."))

register_scenario(Scenario(
    name="disk_shadowed",
    shadowing=ShadowingSpec(sigma_db=8.0),
    description="Disk + 8 dB log-normal shadowing on top of path loss."))

register_scenario(Scenario(
    name="two_cluster",
    geometry=GeometrySpec(kind="two_cluster"),
    description="Near/far clusters (150 m vs 1600 m): the extreme "
                "heterogeneity regime where bias control matters most."))

register_scenario(Scenario(
    name="ring",
    geometry=GeometrySpec(kind="ring", r_min=1000.0),
    fading=FadingSpec(family="nakagami", nakagami_m=1.5),
    description="Cell-edge annulus (1000-1750 m) with Nakagami-1.5 fading: "
                "homogeneous gains, weak channels."))

register_scenario(Scenario(
    name="disk_markov",
    dynamics=DynamicsSpec(rho=0.95),
    description="Disk-Rayleigh with Gauss-Markov round correlation rho=0.95 "
                "(slow fading relative to the round cadence)."))

register_scenario(Scenario(
    name="disk_dropout",
    dynamics=DynamicsSpec(p_dropout=0.1),
    description="Disk-Rayleigh where each device independently drops out of "
                "10% of rounds (outage/straggler model)."))

register_scenario(Scenario(
    name="urban_canyon",
    geometry=GeometrySpec(kind="two_cluster", near_center=120.0,
                          far_center=1500.0, cluster_spread=80.0),
    fading=FadingSpec(family="rician",
                      rician_k=(8.0, 8.0, 8.0, 8.0, 8.0,
                                0.8, 0.8, 0.8, 0.8, 0.8)),
    shadowing=ShadowingSpec(sigma_db=6.0),
    dynamics=DynamicsSpec(rho=0.9, p_dropout=0.05),
    description="Everything at once: clustered geometry, shadowing, mixed "
                "Rician K, correlated fading, 5% dropout."))

# The default grid the benchmarks sweep (>= 4 families, baseline first).
SWEEP_FAMILIES = ("disk_rayleigh", "disk_rician", "disk_shadowed",
                  "two_cluster")
