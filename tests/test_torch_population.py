"""The port's population layer and population mode (``core/scenarios.py``'s
``Population``, ``run_fleet(population=...)``, ``AdaptiveSCA``'s cohort
redesign).

In process, bitwise against ``repro.core.scenarios`` (numpy only, it
imports without JAX's missing pieces): the hashes, the cohort draws, the
gains of every geometry, the weights, the re-entry states, the
descriptors.

Against the reference's population fleet (``repro.fl.driver.run_fleet``
in a child process, ``tests/torch_ref.py::run_reference_population``): a
shrunk paper_mlp (hidden 16, mnist_like(40), 4 rounds, seeds (0, 1), a
2,000-device traffic-weighted population, cohort 10 redrawn every 2
rounds): the cohort trace bitwise; the cohort fleet, minibatch 8 and full
batch, on the reference's own h (rebuilt on each round's cohort gains),
noise and minibatch draws at rtol 1e-4, atol 1e-5 (as
``test_torch_fleet.py``: the two sides order f32 sums differently); the
cohort redesign at 1e-6 in gamma; ``chunk_lengths`` with cohort
boundaries.

The port against itself, bitwise: full participation, stream against
serial, kill and resume (a Gauss-Markov population's re-entry table, and
``adaptive_sca``), the cohort step against the plain step; and the
refusals.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import torch_ref
from repro.core import scenarios as ref_scn
from repro_torch import solvers
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import channel, ota, power_control as tpc
from repro_torch.core import scenarios as scn
from repro_torch.core.theory import OTAParams
from repro_torch.fl import driver as tdriver
from repro_torch.fl.draws import DeviceDraws, ReplayDraws
from repro_torch.fl.engine import chunk_lengths
from repro_torch.models.param import params_from_jax
from repro_torch.solvers import sca as solver_sca
from repro_torch.tasks.image import make_paper_mlp
from torch_ref import one_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-5)
ROUNDS, EVERY, BATCH, SEEDS = 4, 2, 8, (0, 1)
COHORT, COHORT_ROUNDS, SIZE, POP_SEED = 10, 2, 2000, 3
SMALL = dataclasses.replace(solvers.DEFAULT_CONFIG, max_iters=2,
                            inner_iters=5, polish_adam_iters=5,
                            polish_iters=3)
GEOMETRIES = ("disk", "ring", "two_cluster", "grid")


def _geometry(mod, kind):
    return {"disk": mod.GeometrySpec(),
            "ring": mod.GeometrySpec(kind="ring", r_min=1000.0),
            "two_cluster": mod.GeometrySpec(kind="two_cluster"),
            "grid": mod.GeometrySpec(kind="grid", r_min=20.0)}[kind]


def _pair(size=5000, geometry="disk", sampling="traffic", seed=7,
          shadowing=True, dynamics=None, fading=None):
    """The same parametric population in the reference and in the port."""
    out = []
    for mod in (ref_scn, scn):
        kw = {}
        if dynamics is not None:
            kw["dynamics"] = mod.DynamicsSpec(**dynamics)
        if fading is not None:
            kw["fading"] = type(mod.RAYLEIGH)(**fading)
        spec = mod.PopulationSpec(
            size=size, geometry=_geometry(mod, geometry),
            shadowing=mod.ShadowingSpec(sigma_db=8.0) if shadowing else None,
            sampling=sampling, seed=seed, **kw)
        out.append(mod.Population(spec=spec))
    return out


# ---------------------------------------------------------------------------
# the population layer, bitwise against the reference (in process)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,lane", [(0, 0), (3, 1), (2**40 + 5, 4),
                                       (12345, 6)])
def test_hashes_bitwise(seed, lane):
    idx = np.concatenate([np.arange(1000), [2**31, 2**40, 999_999]])
    np.testing.assert_array_equal(
        scn._splitmix64(idx.astype(np.uint64) * np.uint64(seed + 1)),
        ref_scn._splitmix64(idx.astype(np.uint64) * np.uint64(seed + 1)))
    for fn in ("_hash_u01", "_hash_normal"):
        got = getattr(scn, fn)(seed, idx, lane)
        want = getattr(ref_scn, fn)(seed, idx, lane)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sampling", ["uniform", "traffic"])
def test_draw_cohort_bitwise(sampling):
    ref, port = _pair(sampling=sampling)
    for seed in (0, 1, 5):
        for tick in (0, 1, 2, 17):
            got = port.draw_cohort(50, tick, seed)
            np.testing.assert_array_equal(got,
                                          ref.draw_cohort(50, tick, seed))
            assert got.dtype == np.int64 and np.all(np.diff(got) > 0)
    np.testing.assert_array_equal(port.draw_cohort(port.size, 3, 1),
                                  np.arange(port.size))
    for n in (0, port.size + 1):
        with pytest.raises(ValueError, match="cohort size"):
            port.draw_cohort(n, 0, 0)


@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("shadowing", [False, True])
def test_gains_of_bitwise(geometry, shadowing):
    ref, port = _pair(geometry=geometry, shadowing=shadowing)
    idx = np.concatenate([port.draw_cohort(64, 0, 0), [0, port.size - 1]])
    np.testing.assert_array_equal(port.distances_of(idx),
                                  ref.distances_of(idx))
    np.testing.assert_array_equal(port.gains_of(idx), ref.gains_of(idx))


def test_weights_describe_and_tabular_bitwise():
    ref, port = _pair()
    np.testing.assert_array_equal(port.weights(), ref.weights())
    assert port.describe() == ref.describe()
    ref_u, port_u = _pair(sampling="uniform")
    assert port_u.weights() is None and ref_u.weights() is None
    dep = channel.deploy(channel.WirelessConfig(num_devices=12, seed=4))
    w = np.linspace(1.0, 3.0, 12)
    tab = scn.Population.from_deployment(dep, weights=w)
    ref_tab = ref_scn.Population(gains_table=dep.gains, weights_table=w,
                                 name=f"deployment[{dep.num_devices}]")
    assert tab.describe() == ref_tab.describe()
    np.testing.assert_array_equal(tab.gains_of([3, 1]), dep.gains[[3, 1]])
    for tick in range(3):
        np.testing.assert_array_equal(tab.draw_cohort(5, tick, 2),
                                      ref_tab.draw_cohort(5, tick, 2))


@pytest.mark.parametrize("rho,family", [(0.95, "rayleigh"),
                                        (0.9, "rician"), (0.0, "rayleigh")])
def test_reentry_states_bitwise(rho, family):
    fading = {"family": family, "rician_k": 4.0} if family == "rician" \
        else None
    ref, port = _pair(size=300, dynamics={"rho": rho}, fading=fading)
    tables = [pop.init_table(2) for pop in (ref, port)]
    for t0, tick in ((0, 0), (4, 1), (5, 2), (9, 3)):
        for row in range(2):
            idx = port.draw_cohort(40, tick, row)
            got = port.stage_states(tables[1], row, idx, t0, seed=row)
            want = ref.stage_states(tables[0], row, idx, t0, seed=row)
            assert got.dtype == np.complex64
            np.testing.assert_array_equal(got, want)
            state = (got * np.complex64(0.5 + 0.25j)).astype(np.complex64)
            for pop, table in zip((ref, port), tables):
                pop.commit_states(table, row, idx, t0 + 3, state)
    for key in ("last", "state"):
        np.testing.assert_array_equal(tables[1][key], tables[0][key])


def test_population_spec_refusals_and_fading_process():
    with pytest.raises(ValueError, match="positive"):
        scn.PopulationSpec(size=0)
    with pytest.raises(ValueError, match="sampling"):
        scn.PopulationSpec(sampling="zipf")
    with pytest.raises(ValueError, match="scalar"):
        scn.PopulationSpec(fading=channel.FadingSpec(
            family="rician", rician_k=(1.0, 2.0)))
    with pytest.raises(ValueError, match="nakagami"):
        scn.Population(spec=scn.PopulationSpec(
            fading=channel.FadingSpec(family="nakagami", nakagami_m=2.0),
            dynamics=scn.DynamicsSpec(rho=0.5)))
    assert scn.Population(spec=scn.PopulationSpec()).fading_process() is None
    fp = scn.Population(spec=scn.PopulationSpec(
        dynamics=scn.DynamicsSpec(rho=0.9, p_dropout=0.1))).fading_process()
    assert isinstance(fp, scn.FadingProcess) and fp.gains is None
    assert (fp.rho, fp.p_dropout, fp.family) == (0.9, 0.1, "rayleigh")


@pytest.mark.parametrize("name", ["disk_markov", "urban_canyon",
                                  "disk_nakagami", "disk_dropout"])
def test_cohort_step_with_deployment_gains_is_the_step(name):
    """The cohort step on the deployment's own gains, scale and LOS
    (operands) is bitwise the process's plain step."""
    sc = scn.get_scenario(name)
    dep = scn.realize(sc, seed=0)
    fp = scn.make_fading_process(dep, sc.dynamics)
    n = dep.num_devices
    stack = fp.as_stack()
    draws = DeviceDraws(SEEDS, None, [1], 0, 1, CPU, fading=stack)
    state = stack.init_grid(draws.init())
    innov = draws(3).fade
    want = stack.step(state, innov)
    ops = {k: torch.as_tensor(v) for k, v in fp.cohort_operands(
        np.broadcast_to(dep.gains, (len(SEEDS), n))).items()}
    cohort = dataclasses.replace(fp, gains=None).cohort_stack(n)
    for st in (stack, cohort):
        got = st.step(state, innov, ops)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# against the reference's population fleet (child process)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return torch_ref.run_reference_population(
        tmp_path_factory.mktemp("pop") / "pop.npz", rounds=ROUNDS,
        every=EVERY, batch=BATCH, seeds=SEEDS, cohort=COHORT,
        cohort_rounds=COHORT_ROUNDS, size=SIZE, pop_seed=POP_SEED)


@pytest.fixture(scope="module")
def task():
    return make_paper_mlp(hidden=16, samples_per_class=40)


@pytest.fixture(scope="module")
def td(task):
    return task.build_data(0)


@pytest.fixture(scope="module")
def world(task):
    w = channel.WirelessConfig(num_devices=COHORT, seed=0)
    dep = channel.deploy(w)
    prm = OTAParams(d=task.param_dim, gmax=10.0, es=w.energy_per_sample, n0=w.noise_psd,
                    gains=dep.gains, sigma_sq=np.zeros(COHORT), eta=0.05,
                    lsmooth=1.0, kappa_sq=4.0)
    return dep, prm


def _population(size=SIZE, **kw):
    return scn.Population(spec=scn.PopulationSpec(
        size=size, shadowing=scn.ShadowingSpec(), sampling="traffic",
        seed=POP_SEED, **kw))


def _ref_schemes(ref):
    return [tpc.scheme_from_jax(str(ref[f"scheme{i}/name"]),
                                torch_ref.prefixed(ref, f"scheme{i}"))
            for i in range(len(torch_ref.POP_SCHEMES))]


@pytest.mark.parametrize("tag,batch,flat", [("minibatch", BATCH, True),
                                            ("full_batch", 0, False)])
def test_cohort_fleet_matches_reference(ref, task, td, tag, batch, flat):
    """The cohort fleet (S = 2 seed rows on different cohorts) on the
    reference's replayed draws; its cohort trace bitwise."""
    schemes = _ref_schemes(ref)
    run = task.run_config(eta=0.05, num_rounds=ROUNDS, eval_every=EVERY,
                          seed=0, batch_size=batch)
    draws = ReplayDraws(ref["h"], ref["draws/z"],
                        ref["draws/idx"] if batch else None,
                        ref["draws/coin"], CPU)
    res = tdriver.run_fleet_task(
        task, schemes, ref["gains"], run, task_data=td,
        params=params_from_jax(torch_ref.prefixed(ref, "params0")),
        seeds=SEEDS, flat=flat, etas=[0.05] * len(schemes), draws=draws,
        population=_population(), cohort_size=COHORT,
        cohort_rounds=COHORT_ROUNDS, stream=False, device="cpu")
    assert [t for t, _ in res.cohorts] == list(ref[f"{tag}/cohorts_t"])
    np.testing.assert_array_equal(np.stack([i for _, i in res.cohorts]),
                                  ref[f"{tag}/cohorts_idx"])
    want = torch_ref.prefixed(ref, f"{tag}/params")
    for k in ("b1", "b2", "w1", "w2"):
        np.testing.assert_allclose(res.params[k].numpy(), want[k], **TOL,
                                   err_msg=k)
    for k, v in torch_ref.prefixed(ref, f"{tag}/traces").items():
        np.testing.assert_allclose(res.traces[k], v, **TOL, err_msg=k)
    assert [t for t, _ in res.evals] == list(ref[f"{tag}/evals_t"])
    for k, v in torch_ref.prefixed(ref, f"{tag}/evals").items():
        np.testing.assert_allclose(np.stack([ev[k] for _, ev in res.evals]),
                                   v, **TOL, err_msg=k)


def test_cohort_redesign_matches_reference(ref, world):
    """``redesign_cohort_fn`` on the tick-0 cohorts' gains [S, N] against
    the reference's (both the default solver)."""
    dep, prm = world
    pc = tpc.make_adaptive_sca(dep, prm, base=tpc.make_sca(dep, prm,
                                                           method="scipy"))
    new = pc.redesign_cohort_fn(pc, ref["redesign/gains"])
    assert new.gamma.shape == (2, COHORT) and new.alpha.shape == (2,)
    for f in ("gamma", "alpha", "p"):
        got, want = np.asarray(getattr(new, f)), ref[f"redesign/{f}"]
        assert np.max(np.abs(got - want) / np.abs(want)) <= 1e-6, f


def test_project_simplex_on_a_non_finite_row():
    """An overflowed inner step hands the projection a non-finite row
    (rho = 0): its index wraps to the last entry, as the reference's
    ``take_along_axis`` does, and the row stays non-finite (rejected by
    the true-objective backtracking) instead of raising."""
    v = torch.tensor([[0.2, 0.5, 0.1], [float("nan"), 0.3, float("inf")]],
                     dtype=torch.float64)
    out = solver_sca.project_simplex(v)
    assert torch.allclose(out[0].sum(), torch.tensor(1.0, dtype=out.dtype))
    assert not torch.isfinite(out[1]).all()


def test_cohort_redesign_matches_committed_reference():
    """The population benchmark's world (paper_mlp at full width, 50
    devices) re-designed on seed 0's tick-4 cohort of the 1M-device
    population against the reference's committed design: the cohort holds
    a device of gain 3e-15 whose first inner stage overflows (tick 0 is
    held on the card, ``chip_smoke.py`` phase 10)."""
    key = "0/4"
    from repro_torch import fig2, tasks
    with open(torch_ref.POP_REF_DIR / "population.json") as f:
        ref = json.load(f)
    task = tasks.get("paper_mlp", expect_runtime="fleet")
    dep, prm, _ = fig2.build_world(task, 0, num_devices=50)
    prm = prm.replace(eta=task.eta_for("adaptive_sca", float(prm.eta)))
    pc = tpc.make_adaptive_sca(dep, prm, base=tpc.make_sca(dep, prm,
                                                           method="scipy"))
    gains = np.asarray(ref["cohorts"][key]["gains"])
    np.testing.assert_array_equal(fig2.make_population(ref["size"]).gains_of(
        ref["cohorts"][key]["idx"]), gains)
    new = pc.redesign_cohort_fn(pc, gains[None])
    for f in ("gamma", "alpha", "p"):
        got = np.asarray(getattr(new, f)).reshape(-1)
        want = np.asarray(ref["redesigns"][key][f])
        assert np.max(np.abs(got - want) / np.abs(want)) <= 1e-6, f


@pytest.mark.parametrize("case", torch_ref.POP_CHUNK_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_chunk_lengths_with_cohorts_match_reference(ref, case):
    t, e, c = case
    got = chunk_lengths(t, e, True, cohort_rounds=c)
    np.testing.assert_array_equal(got, ref["chunk_lengths/%d-%d-%d" % case])
    assert chunk_lengths(t, e, True) == chunk_lengths(t, e, True, None)


# ---------------------------------------------------------------------------
# the port against itself, bitwise
# ---------------------------------------------------------------------------

def _kw(task, td, **kw):
    return dict(task_data=td, params=task.init_params(0, CPU), flat=True,
                device="cpu", **kw)


def _same(a, b):
    return all(torch.equal(a.params[k], b.params[k]) for k in a.params) \
        and all(np.array_equal(a.traces[k], b.traces[k]) for k in a.traces) \
        and len(a.evals) == len(b.evals) \
        and all(np.array_equal(x[k], y[k]) for (_, x), (_, y)
                in zip(a.evals, b.evals) for k in x)


@pytest.mark.parametrize("batch", [BATCH, 0])
def test_full_participation_is_the_plain_fleet(task, td, world, batch):
    """A cohort equal to the deployment-as-population gives the plain
    fleet's numbers, minibatch and full batch, at S = 2."""
    dep, prm = world
    pcs = [tpc.make_power_control(n, dep, prm, **(
        {"method": "scipy"} if n == "sca" else {}))
        for n in ("sca", "lcpc", "bbfl_alternative")]
    run = task.run_config(num_rounds=6, eval_every=3, seed=0,
                          batch_size=batch)
    kw = _kw(task, td, seeds=SEEDS, eval_fn=task.make_eval(td, CPU))
    plain = tdriver.run_fleet_task(task, pcs, dep.gains, run, **kw)
    full = tdriver.run_fleet_task(
        task, pcs, dep.gains, run, **kw,
        population=scn.Population.from_deployment(dep), cohort_size=COHORT,
        stream=False)
    assert _same(plain, full)
    assert all(np.array_equal(i, np.tile(np.arange(COHORT), (2, 1)))
               for _, i in full.cohorts)


def _adaptive(world, task):
    dep, prm = world
    return tpc.make_adaptive_sca(dep, prm, base=tpc.make_sca(
        dep, prm, method="scipy"), cfg=SMALL)


def test_stream_is_serial_bitwise(task, td, world):
    """adaptive_sca on a 2,000-device population, a cohort redesign per
    tick: stream on and off agree in params, traces, evals, cohorts and
    designs; the first design is the tick-0 cohort's."""
    pc = _adaptive(world, task)
    run = task.run_config(num_rounds=8, eval_every=4, seed=0,
                          batch_size=BATCH)
    kw = _kw(task, td, seeds=SEEDS, population=_population(),
             cohort_size=COHORT, cohort_rounds=COHORT_ROUNDS)
    on = tdriver.run_fleet_task(task, [pc], world[0].gains, run, **kw,
                                stream=True)
    off = tdriver.run_fleet_task(task, [pc], world[0].gains, run, **kw,
                                 stream=False)
    assert _same(on, off)
    assert [t for t, _ in on.designs] == [t for t, _ in on.cohorts] \
        == [0, 2, 4, 6]
    for x, y in ((on.designs, off.designs), (on.cohorts, off.cohorts)):
        assert all(a[0] == b[0] and np.array_equal(a[1], b[1])
                   for a, b in zip(x, y))
    assert len(on.stage_walls) == len(chunk_lengths(8, 4, True, 2))
    g0 = np.stack([_population().gains_of(i) for i in on.cohorts[0][1]])
    np.testing.assert_array_equal(on.designs[0][1][0],
                                  pc.redesign_cohort_fn(pc, g0).gamma)


@pytest.mark.parametrize("kind", ["gauss_markov", "adaptive"])
def test_kill_and_resume_bitwise(task, td, world, tmp_path, kind):
    """Stopped after 2 chunks and resumed: bitwise the uninterrupted run,
    with the cohort trace, the designs and the re-entry table."""
    dep, prm = world
    if kind == "gauss_markov":
        pop = scn.Population(spec=scn.PopulationSpec(
            size=30, dynamics=scn.DynamicsSpec(rho=0.95)))
        pcs = [tpc.make_power_control("sca", dep, prm, method="scipy")]
    else:
        pop, pcs = _population(), [_adaptive(world, task)]
    run = task.run_config(num_rounds=12, eval_every=6, seed=0,
                          batch_size=BATCH)
    kw = _kw(task, td, seeds=SEEDS, eval_fn=task.make_eval(td, CPU),
             population=pop, cohort_size=COHORT, cohort_rounds=2)
    whole = tdriver.run_fleet_task(task, pcs, dep.gains, run, **kw,
                                   checkpoint_path=str(tmp_path / "whole"))
    path = str(tmp_path / "fleet")
    first = tdriver.run_fleet_task(task, pcs, dep.gains, run, **kw,
                                   checkpoint_path=path, max_chunks=2)
    rest = tdriver.run_fleet_task(task, pcs, dep.gains, run, **kw,
                                  checkpoint_path=path, resume=True)
    assert sum(n for n, _ in first.chunk_walls) < 12
    assert _same(whole, rest)
    for x, y in ((whole.cohorts, rest.cohorts),
                 (whole.designs or [], rest.designs or [])):
        assert len(x) == len(y) and all(
            a[0] == b[0] and np.array_equal(a[1], b[1]) for a, b in zip(x, y))
    a, b = ckpt.load_flat(str(tmp_path / "whole")), ckpt.load_flat(path)
    if kind == "gauss_markov":
        assert torch.equal(whole.fading_state, rest.fading_state)
        slots = sum(i.size for _, i in whole.cohorts)
        seen = sum(np.unique(np.concatenate([i[r] for _, i in whole.cohorts]))
                   .size for r in range(len(SEEDS)))
        assert slots - seen > 0                         # devices re-entered
        for key in ("pop_last", "pop_state"):
            np.testing.assert_array_equal(a[key], b[key])
    np.testing.assert_array_equal(a["cohorts_idx"], b["cohorts_idx"])


def test_refusals(task, td, world, tmp_path):
    dep, prm = world
    pcs = [tpc.make_power_control("sca", dep, prm, method="scipy")]
    run = task.run_config(num_rounds=4, eval_every=2, seed=0,
                          batch_size=BATCH)
    kw = _kw(task, td, population=_population(), cohort_size=COHORT)
    with pytest.raises(ValueError, match="cohort"):
        tdriver.run_fleet_task(task, pcs, dep.gains, run, **dict(
            kw, cohort_size=7))
    with pytest.raises(ValueError, match="cohort size"):
        tdriver.run_fleet_task(task, pcs, dep.gains, run, **dict(
            kw, population=scn.Population.from_deployment(
                channel.deploy(channel.WirelessConfig(num_devices=5)))))
    with pytest.raises(ValueError, match="exclusive"):
        tdriver.run_fleet_task(task, pcs, None, run, **kw,
                               scenarios=scn.stack_scenarios(
                                   ["disk_rayleigh"]))
    with pytest.raises(TypeError, match="Placement"):
        tdriver.run_fleet_task(task, pcs, dep.gains, run, **kw,
                               placement="on")
    path = str(tmp_path / "fleet")
    tdriver.run_fleet_task(task, pcs, dep.gains, run, **kw,
                           checkpoint_path=path, max_chunks=1)
    with pytest.raises(ValueError, match="population"):
        tdriver.run_fleet_task(task, pcs, dep.gains, run, **dict(
            kw, population=_population(size=SIZE + 1)),
            checkpoint_path=path, resume=True)
    with pytest.raises(ValueError, match="cohort_rounds"):
        tdriver.run_fleet_task(task, pcs, dep.gains, run, **kw,
                               cohort_rounds=2, checkpoint_path=path,
                               resume=True)
