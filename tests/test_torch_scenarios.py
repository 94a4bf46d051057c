"""The port's scenario layer (``repro_torch.core.scenarios``, the fading
transforms of ``core.ota``, the dropout-aware schemes and ``AdaptiveSCA``)
against the reference's ``repro.core.scenarios`` and
``repro.core.power_control``, run in a child process
(``tests/torch_ref.py::run_reference_scenario_worlds``).

Tolerances, each stated where it is held:

* ``realize`` and ``make_ota_params``: bitwise (the same float64 numpy).
* The fading transforms on the reference's own random numbers -- the
  normals its Rayleigh / Rician / Gauss-Markov steps consume, its Gamma
  variates and phase uniforms for Nakagami, its dropout uniforms and keep
  mask: bitwise for every family.  The per-device constants are float32
  numpy on the host (the reference's correctly rounded float32 sqrt),
  Nakagami's magnitude, cos and sin float64 rounded to float32.
* Stack rows against standalone processes: bitwise.
* The redesign of a given state: 1e-6 relative, as the solver's designs
  (``test_torch_solvers.py``).
* The generator-driven draws, in distribution (no JAX stream to replay):
  each statistic within a stated multiple of its standard error.
"""
import dataclasses

import numpy as np
import pytest
import scipy.stats
import torch

import torch_ref
from repro_torch import scenario_sweep as ss
from repro_torch import solvers
from repro_torch.core import channel, ota, power_control as tpc
from repro_torch.core import scenarios as scn
from repro_torch.fl.draws import DeviceDraws

CPU = torch.device("cpu")
NAMES = scn.scenario_names()
FIELDS = ("d", "gmax", "es", "n0", "gains", "sigma_sq", "eta", "lsmooth",
          "kappa_sq", "dropout")
STEPS = 3
DESIGN_RTOL = 1e-6


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return torch_ref.run_reference_scenario_worlds(
        tmp_path_factory.mktemp("scn") / "worlds.npz", steps=STEPS)


def _world(name):
    sc = scn.get_scenario(name)
    dep = scn.realize(sc, seed=0)
    return sc, dep, scn.make_fading_process(dep, sc.dynamics)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_registry_is_the_reference_registry():
    assert NAMES == ("disk_rayleigh", "disk_rician", "disk_rician_mixed",
                     "disk_nakagami", "disk_shadowed", "two_cluster", "ring",
                     "disk_markov", "disk_dropout", "urban_canyon")
    assert scn.SWEEP_FAMILIES == torch_ref.SCN_FAMILIES
    assert all(n in NAMES for n in scn.SWEEP_FAMILIES)


@pytest.mark.parametrize("name", NAMES)
def test_realize_matches_reference_bitwise(ref, name):
    _, dep, _ = _world(name)
    assert np.array_equal(dep.distances, ref[name + "/distances"])
    assert np.array_equal(dep.gains, ref[name + "/gains"])
    shadow = np.zeros(0) if dep.shadowing_db is None else dep.shadowing_db
    assert np.array_equal(shadow, ref[name + "/shadowing_db"])
    assert dep.p_dropout == float(ref[name + "/p_dropout"])


@pytest.mark.parametrize("name", NAMES)
def test_ota_params_match_reference_bitwise(ref, name):
    _, dep, _ = _world(name)
    prm = scn.make_ota_params(dep, d=814090, gmax=10.0, eta=0.05,
                              kappa_sq=4.0)
    for f in FIELDS:
        assert np.array_equal(np.asarray(getattr(prm, f), np.float64),
                              ref[f"{name}/prm/{f}"]), f
    fam = "rayleigh" if prm.fading is None else prm.fading.family
    assert fam == str(ref[name + "/prm/family"])


def test_disk_rayleigh_is_channel_deploy():
    dep = scn.realize(scn.get_scenario("disk_rayleigh"))
    base = channel.deploy(channel.WirelessConfig())
    assert np.array_equal(dep.gains, base.gains)
    assert np.array_equal(dep.distances, base.distances)
    assert dep.fading_spec == channel.RAYLEIGH and dep.p_dropout == 0.0


@pytest.mark.parametrize("name", NAMES)
def test_fading_steps_match_reference_bitwise(ref, name):
    """Each step of the standalone process on the reference's own random
    numbers: h, the state and the dropout mask bitwise; the initial
    state too."""
    _, _, fp = _world(name)
    st = fp.init(ota.Innovations(_t(ref[name + "/init/n_re"]),
                                 _t(ref[name + "/init/n_im"])))
    assert np.array_equal(st.numpy(), ref[name + "/init/state"])
    p = {k: v[0] for k, v in fp.as_stack()._params(CPU, 0).items()}
    for t in range(STEPS):
        pre = f"{name}/step{t}/"
        state_in = _t(ref[pre + "state_in"])
        drop_u = _t(ref[pre + "drop_u"]) if pre + "drop_u" in ref else None
        if fp.family == "nakagami":
            h = ota.nakagami_fading(p["gains"], p["m"], _t(ref[pre + "gamma"]),
                                    _t(ref[pre + "phase_u"]))
            state = state_in
        else:
            state, h = fp.step(state_in, ota.Innovations(
                _t(ref[pre + "n_re"]), _t(ref[pre + "n_im"]), drop_u))
        assert np.array_equal(h.numpy(), ref[pre + "h"]), t
        assert np.array_equal(state.numpy(), ref[pre + "state"]), t
        if drop_u is not None:
            assert np.array_equal((drop_u < p["keep"]).numpy(),
                                  ref[pre + "keep"])


def _innovations(proc, seeds, rounds):
    d = DeviceDraws(seeds, None, [3], 0, 1, CPU, fading=proc)
    return d.init(), [d(t).fade for t in range(rounds)]


def test_stack_rows_match_fading_processes_bitwise():
    """All ten scenarios as one stack, stepped on shared innovations: row
    c's states and h are bitwise scenario c's standalone process on its
    own draws provider (the dropout and Gamma inputs come from salted
    streams of their own, so a row does not see which other rows the
    stack holds)."""
    stack = scn.stack_scenarios(NAMES, seed=0)
    seeds, rounds = (0, 1, 2), 6
    init, steps = _innovations(stack, seeds, rounds)
    states = stack.init_grid(init)
    hs = []
    for inn in steps:
        states, h = stack.step(states, inn)
        hs.append(h)
    for c, name in enumerate(NAMES):
        _, _, fp = _world(name)
        init_c, steps_c = _innovations(fp, seeds, rounds)
        st = fp.init(init_c)
        for t, inn in enumerate(steps_c):
            st, h = fp.step(st, inn)
            assert torch.equal(h, hs[t][c]), (name, t)
        assert torch.equal(st, states[c]), name
    assert len(stack) == len(NAMES) and stack.needs_dropout \
        and stack.needs_nakagami


@pytest.mark.parametrize("name", ["disk_rician_mixed", "disk_markov",
                                  "urban_canyon"])
def test_process_steps_over_any_leading_axes(name):
    """A process (a one-row stack) broadcasts over the innovations'
    leading axes: one device row [N], seed rows [S, N] and [A, S, N] give
    each row's h and state bitwise as the [S, N] step of that row."""
    _, _, fp = _world(name)
    gen = _gen(11)
    a, s = 3, 4
    init = ota.Innovations(*ota.draw_normals((a, s, 10), gen, CPU))
    inn = ota.Innovations(*ota.draw_normals((a, s, 10), gen, CPU),
                          torch.rand((a, s, 10), generator=gen))
    st, h = fp.step(fp.init(init), inn)
    assert h.shape == st.shape == (a, s, 10)
    for i in range(a):
        sub = ota.Innovations(inn.n_re[i], inn.n_im[i], inn.drop_u[i])
        st_i, h_i = fp.step(fp.init(ota.Innovations(init.n_re[i],
                                                    init.n_im[i])), sub)
        assert torch.equal(h_i, h[i]) and torch.equal(st_i, st[i])
        one = ota.Innovations(sub.n_re[0], sub.n_im[0], sub.drop_u[0])
        st_1, h_1 = fp.step(fp.init(ota.Innovations(init.n_re[i, 0],
                                                    init.n_im[i, 0])), one)
        assert h_1.shape == (10,)
        assert torch.equal(h_1, h_i[0]) and torch.equal(st_1, st_i[0])


def test_stack_fields_and_describe():
    stack = scn.stack_scenarios(scn.SWEEP_FAMILIES)
    assert stack.names == scn.SWEEP_FAMILIES and stack.gains.shape == (4, 10)
    assert np.array_equal(stack.k_factor[1], np.full(10, 5.0))
    assert np.array_equal(stack.k_factor[0], np.zeros(10))
    assert stack.describe() == scn.stack_scenarios(
        scn.SWEEP_FAMILIES).describe()
    assert stack.describe() != scn.stack_scenarios(
        scn.SWEEP_FAMILIES[:3]).describe()
    assert np.array_equal(stack.kind, [0, 1, 0, 0])


def test_iid_rayleigh_process_is_the_paper_path():
    """The i.i.d. Rayleigh process turns its innovations into h with the
    very ops of the paper's path: the same h, bitwise, and the same noise,
    minibatch and coin draws."""
    _, dep, fp = _world("disk_rayleigh")
    plain = DeviceDraws((0, 3), dep.gains, [5, 7], 4, 40, CPU)
    proc = DeviceDraws((0, 3), dep.gains, [5, 7], 4, 40, CPU, fading=fp)
    for t in range(3):
        a, b = plain(t), proc(t)
        _, h = fp.step(None, b.fade)
        assert torch.equal(a.h, h)
        for x, y in zip(a[1:], b[1:]):
            assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# The generator-driven draws, in distribution
# ---------------------------------------------------------------------------

ROWS = 20_000     # x 10 devices: 200,000 draws a statistic


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("family,param", [
    ("rayleigh", None), ("rician", 5.0),
    ("rician", (10.0,) * 5 + (0.5,) * 5), ("nakagami", 2.0),
    ("nakagami", 0.7), ("nakagami", 1.5), ("nakagami", 0.5)])
def test_mean_power_equals_gain(family, param):
    """E|h|^2 = Lambda for every family: the mean of |h|^2 / Lambda over
    200,000 draws within 0.02 of 1.  The normalized power has variance
    <= 1 / m <= 2 (m >= 0.5), a standard error <= 0.0032: 0.02 is > 6
    standard errors."""
    gains = torch.as_tensor(channel.deploy(channel.WirelessConfig()).gains)
    if family == "rayleigh":
        h = ota.draw_fading(gains, ROWS, _gen(1))
    elif family == "rician":
        h = ota.draw_fading_rician(gains, torch.as_tensor(param), ROWS,
                                   _gen(2))
    else:
        h = ota.draw_fading_nakagami(gains, torch.full((10,), param), ROWS,
                                     _gen(3))
    assert h.shape == (ROWS, 10) and h.dtype == torch.complex64
    ratio = (h.abs().double() ** 2 / gains).mean()
    assert abs(float(ratio) - 1.0) < 0.02


@pytest.mark.parametrize("m", [0.5, 0.7, 1.0, 1.5, 2.0, 10.0])
def test_gamma_variates_moments(m):
    """Marsaglia-Tsang in masked rounds (and the m < 1 boost): mean m and
    variance m of Gamma(m, 1) over 200,000 draws, within 2 % and 5 %
    (standard errors sqrt(m / n) / m <= 0.45 % and sqrt(2 + 6 / m) / sqrt(n)
    <= 0.8 % of the mean and variance)."""
    shape = (ROWS, 10)
    gn, gu, bu, _ = ota.draw_gamma_inputs(shape, _gen(4), CPU)
    g = ota.gamma_variates(torch.full((10,), m, dtype=torch.float64), gn, gu,
                           bu)
    assert g.dtype == torch.float64 and bool((g > 0).all())
    assert abs(float(g.mean()) / m - 1.0) < 0.02
    assert abs(float(g.var()) / m - 1.0) < 0.05


def test_nakagami_m1_is_rayleigh():
    """Nakagami with m = 1 is Rayleigh: |h|^2 / Lambda is Exp(1), by a
    Kolmogorov-Smirnov test at 200,000 draws (p > 1e-3), and its phase is
    uniform (p > 1e-3)."""
    gains = torch.as_tensor(channel.deploy(channel.WirelessConfig()).gains)
    h = ota.draw_fading_nakagami(gains, torch.ones(10), ROWS, _gen(5))
    x = (h.abs().double() ** 2 / gains).flatten().numpy()
    assert scipy.stats.kstest(x, "expon").pvalue > 1e-3
    phase = np.angle(h.numpy().flatten())
    assert scipy.stats.kstest(phase, "uniform", args=(-np.pi, 2 * np.pi)) \
        .pvalue > 1e-3


def test_dropout_rate():
    """disk_dropout (p = 0.1) and urban_canyon (p = 0.05) drop devices at
    their rate: the share of h = 0 over 200,000 device-rounds within 0.005
    of p (standard error <= 0.0007)."""
    for name in ("disk_dropout", "urban_canyon"):
        sc, _, fp = _world(name)
        gen = _gen(6)
        n_re, n_im = ota.draw_normals((ROWS, 10), gen, CPU)
        inn = ota.Innovations(n_re, n_im, torch.rand((ROWS, 10),
                                                     generator=gen))
        state = fp.init(ota.Innovations(*ota.draw_normals((ROWS, 10), gen,
                                                          CPU)))
        _, h = fp.step(state, inn)
        share = float((h == 0).double().mean())
        assert abs(share - sc.dynamics.p_dropout) < 0.005, name


def test_gauss_markov_lag1_autocorrelation():
    """disk_markov (rho = 0.95): over 20,000 chains of 10 devices started
    stationary, the lag-1 correlation of the scattered state is rho within
    0.005 (standard error ~ (1 - rho^2) / sqrt(n) ~ 2e-4), and the state's
    power stays the diffuse gain (within 2 %)."""
    sc, dep, fp = _world("disk_markov")
    gen = _gen(7)
    s0 = fp.init(ota.Innovations(*ota.draw_normals((ROWS, 10), gen, CPU)))
    s1, _ = fp.step(s0, ota.Innovations(*ota.draw_normals((ROWS, 10), gen,
                                                           CPU)))
    a, b = s0.numpy().astype(np.complex128), s1.numpy().astype(np.complex128)
    corr = np.real(np.sum(a.conj() * b, axis=0)) / np.sum(np.abs(a) ** 2,
                                                          axis=0)
    assert np.all(np.abs(corr - sc.dynamics.rho) < 0.005)
    power = np.mean(np.abs(b) ** 2, axis=0) / dep.gains
    assert np.all(np.abs(power - 1.0) < 0.02)


# ---------------------------------------------------------------------------
# Power control: dropout-aware schemes, AdaptiveSCA
# ---------------------------------------------------------------------------

def _prm(dep):
    return scn.make_ota_params(dep, d=814090, gmax=10.0, eta=0.05,
                               kappa_sq=4.0)


@pytest.mark.parametrize("name", ["vanilla", "opc", "bbfl_interior",
                                  "bbfl_alternative"])
def test_dropout_aware_rounds(name):
    """Built on a dropout world the global-CSI schemes are dropout-aware:
    a dropped device gets s = 0, and a round with every device dropped is
    a no-op (s = 0, noise 0), never NaN."""
    _, dep, _ = _world("disk_dropout")
    pc = tpc.make_power_control(name, dep, _prm(dep))
    assert pc.dropout_aware
    assert not tpc.make_power_control(name, dep, _prm(dep),
                                      dropout_aware=False).dropout_aware
    h = ota.draw_fading(torch.as_tensor(dep.gains), 3, _gen(8))
    h[1, 2] = 0
    h[2] = 0
    s, ns = pc.round_coeffs(h, torch.tensor([True, False, True]))
    assert bool(torch.isfinite(s).all()) and bool(torch.isfinite(ns).all())
    assert float(s[1, 2]) == 0.0 and bool((s[0] > 0).any())
    assert bool((s[2] == 0).all()) and float(ns[2]) == 0.0


def test_scheme_from_jax_keeps_dropout_aware():
    pc = tpc.scheme_from_jax("vanilla", {"p": np.full(10, 0.1), "bmax": 2.0,
                                         "n0": 1e-20, "dropout_aware": 1.0})
    assert pc.dropout_aware
    assert not tpc.scheme_from_jax("opc", {"p": np.full(10, 0.1),
                                           "bmax": 2.0, "n0": 1e-20,
                                           "gmax": 10.0}).dropout_aware


def _adaptive(name, **kw):
    _, dep, fp = _world(name)
    prm = _prm(dep)
    pc = tpc.make_adaptive_sca(dep, prm, base=tpc.make_lcpc(dep, prm), **kw)
    return pc, fp, prm


def test_redesign_matches_reference(ref):
    """The redesign of the reference's given state (two seed rows, one
    batched solve on the CPU) lands within 1e-6 relative of the
    reference's, in gamma, alpha, p and the thresholds."""
    pc, fp, _ = _adaptive("disk_markov")
    pre = "disk_markov/redesign/"
    new = pc.redesign_fn(pc, fp, _t(ref[pre + "state"]))
    assert new.gamma.shape == (2, 10) and new.alpha.shape == (2,)
    for f in ("gamma", "alpha", "p", "thresholds", "noise_over_alpha"):
        got, want = np.asarray(getattr(new, f)), ref[pre + f]
        assert np.max(np.abs(got - want) / np.abs(want)) < DESIGN_RTOL, f


def test_redesign_is_a_noop_on_static_csi():
    pc, _, _ = _adaptive("disk_markov")
    _, _, iid = _world("disk_rayleigh")
    state = torch.zeros((2, 10), dtype=torch.complex64)
    assert pc.redesign_fn(pc, iid, state) is pc
    assert pc.redesign_fn(pc, None, state) is pc
    # the population layer's hook (tests/test_torch_population.py)
    assert callable(pc.redesign_cohort_fn)


def test_adaptive_sca_by_name():
    """``make_power_control("adaptive_sca", ...)`` builds the scheme: its
    initial design is the static solve (here a short budget)."""
    _, dep, _ = _world("disk_markov")
    prm = _prm(dep)
    cfg = dataclasses.replace(solvers.DEFAULT_CONFIG, max_iters=2,
                              inner_iters=5, polish_adam_iters=5,
                              polish_iters=3)
    pc = tpc.make_power_control("adaptive_sca", dep, prm, cfg=cfg,
                                device="cpu")
    assert isinstance(pc, tpc.AdaptiveSCA) and pc.name == "adaptive_sca"
    want = solvers.solve(prm, cfg=cfg, device="cpu").gamma
    assert np.array_equal(pc.gamma, want)
    h = ota.draw_fading(torch.as_tensor(dep.gains), 2, _gen(9))
    s, ns = pc.round_coeffs(h, torch.zeros(2, dtype=torch.bool))
    assert s.shape == (2, 10) and ns.shape == (2,)


def test_theory_rows_match_reference():
    """The sweep's Theorem-1 rows of the Rayleigh- and Nakagami-family
    scenarios (seven of the ten; one batched sca solve per family on the
    CPU) within 1e-6 relative of the reference's committed rows
    (experiments/scenario_reference/theory_seed0.json) in bias, variance
    and objective, and the sca designs within 1e-6 of the reference's
    per-scenario designs.  The three Rician rows are held on the card
    (chip_smoke.py phase 8): their batched solve takes ~140 s on this
    CPU."""
    names = [n for n in NAMES
             if scn.get_scenario(n).fading.family != "rician"]
    _check_theory_rows(ss.design(names, device="cpu"), names)


def test_design_with_a_process_per_family_matches_reference():
    """``design(jobs=2)``: the two families' solves at once, each in a
    spawned process, held as ``test_theory_rows_match_reference`` holds
    the solves one after the other."""
    names = [n for n in NAMES
             if scn.get_scenario(n).fading.family != "rician"]
    _check_theory_rows(ss.design(names, device="cpu", jobs=2), names)


def _check_theory_rows(world, names):
    assert [fam for fam, _, _ in world["sca_calls"]] == ["rayleigh",
                                                          "nakagami"]
    ref = ss.load_theory_reference(0)
    errs = ss.theory_errors(ss.sweep(world), ref)
    assert len(errs) == 3 * len(names)
    assert max(errs.values()) < DESIGN_RTOL, errs
    for n in names:
        got = world[n]["schemes"][0].gamma
        want = np.asarray(ref["sca_designs"][n]["gamma"])
        assert np.max(np.abs(got - want) / want) < DESIGN_RTOL, n


# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda: scn.Scenario(name="x", fading=channel.FadingSpec(
        family="nakagami"), dynamics=scn.DynamicsSpec(rho=0.5)),
    lambda: scn.Scenario(name="x", fading=channel.FadingSpec(
        family="rician", rician_k=(1.0, 2.0))),
    lambda: scn.DynamicsSpec(rho=1.0),
    lambda: scn.DynamicsSpec(p_dropout=-0.1),
    lambda: scn.GeometrySpec(kind="hexagon"),
    lambda: scn.get_scenario("nope"),
    lambda: scn.register_scenario(scn.get_scenario("disk_rayleigh")),
    lambda: scn.stack_deployments([]),
    lambda: scn.make_fading_process(scn.realize(scn.get_scenario(
        "disk_nakagami")), scn.DynamicsSpec(rho=0.5)),
], ids=["nakagami_markov", "k_shape", "rho", "p_dropout", "geometry",
        "unknown", "duplicate", "empty_stack", "process_nakagami_markov"])
def test_invalid_specs_raise(make):
    with pytest.raises(ValueError):
        make()
