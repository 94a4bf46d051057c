"""The port's single-run API and Theorem 1 (``core/theory.py``,
``core/sca.py::solve_direct``, ``fl/server.py``, ``sca_bench``,
``fig2.benchmark``).

In process against ``repro.core.theory`` / ``repro.core.sca`` and
``benchmarks.sca_bench`` (numpy and scipy only): ``theorem1_bound`` and
``uniform_feasible`` at 1e-12 relative, ``solve_direct``'s objective at
1e-9, the trade-off and bound rows.

Against the reference's ``run_fl`` (``repro.fl.server`` in a child
process, ``tests/torch_ref.py::run_reference_population``, part
"run_fl"): a shrunk paper_mlp (hidden 16, mnist_like(40), 4 rounds, sca),
minibatch 8 on the flat fused tail and the paper's full batch, on the
reference's own draws at rtol 1e-4, atol 1e-5; the legacy loop's host
minibatches bitwise.

The port against itself, bitwise: ``run_fl`` is its K = S = 1 fleet;
``run_fl_legacy`` at full batch is ``run_fl`` (on a fading process too);
``run_fl_task`` is ``run_fl``; ``fig2.benchmark``'s legacy and fleet
full-batch histories agree exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

import torch_ref
from benchmarks import sca_bench as ref_bench
from repro.core import channel as ref_channel
from repro.core import sca as ref_sca, theory as ref_theory
from repro.core.theory import OTAParams as RefOTAParams
from repro_torch import fig2, sca_bench
from repro_torch.core import channel, power_control as tpc
from repro_torch.core import sca, scenarios as scn, theory
from repro_torch.core.theory import OTAParams
from repro_torch.fl import driver as tdriver, server
from repro_torch.fl.draws import ReplayDraws
from repro_torch.models.param import params_from_jax
from repro_torch.tasks.image import make_paper_mlp

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-5)
ROUNDS, EVERY, BATCH = 4, 2, 8


def _prm_pair(seed, n, family="rayleigh", dropout=0.0):
    """The same OTAParams in the reference and in the port."""
    rng = np.random.default_rng(seed)
    gains = ref_channel.average_gain(rng.uniform(80.0, 1750.0, size=n))
    sigma = rng.uniform(0.0, 2.0, size=n)
    kappa = float(rng.uniform(0.5, 16.0))
    fparam = rng.uniform(0.6, 6.0, size=n)
    out = []
    for mod, cls in ((ref_channel, RefOTAParams), (channel, OTAParams)):
        fading = None
        if family == "rician":
            fading = mod.FadingSpec(family="rician", rician_k=fparam)
        elif family == "nakagami":
            fading = mod.FadingSpec(family="nakagami", nakagami_m=fparam)
        w = mod.WirelessConfig(num_devices=n)
        out.append(cls(d=814090, gmax=10.0, es=w.energy_per_sample,
                       n0=w.noise_psd, gains=gains, sigma_sq=sigma,
                       eta=0.05, lsmooth=1.0, kappa_sq=kappa, fading=fading,
                       dropout=dropout))
    return out


THEORY_CASES = [(0, 5, "rayleigh", 0.0), (7, 10, "rayleigh", 0.0),
                (3, 8, "rician", 0.0), (4, 8, "nakagami", 0.0),
                (5, 8, "rayleigh", 0.15), (6, 6, "rician", 0.1)]


def _close(got, want, rtol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], rtol)
        return
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=0.0)


@pytest.mark.parametrize("case", THEORY_CASES,
                         ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("frac", [0.3, 0.7, 1.0])
def test_theorem1_bound_matches_reference(case, frac):
    ref_prm, prm = _prm_pair(*case)
    gamma = frac * ref_theory.gamma_max(ref_prm)
    for init_gap, rounds in ((5.0, 50), (0.3, 1000)):
        _close(theory.theorem1_bound(gamma, prm, init_gap, rounds),
               ref_theory.theorem1_bound(gamma, ref_prm, init_gap, rounds),
               1e-12)
    assert theory.uniform_feasible(prm) == ref_theory.uniform_feasible(
        ref_prm)


@pytest.mark.parametrize("seed,n", [(0, 5), (1, 10), (2, 20)])
def test_solve_direct_matches_reference(seed, n):
    ref_prm, prm = _prm_pair(seed, n)
    got = sca.solve_direct(prm, num_starts=4, seed=seed)
    want = ref_sca.solve_direct(ref_prm, num_starts=4, seed=seed)
    assert abs(got.objective - want.objective) <= 1e-9 * abs(want.objective)
    assert got.objective <= ref_theory.p1_objective(
        ref_theory.gamma_max(ref_prm), ref_prm) * (1 + 1e-12)


def test_sca_bench_rows_match_reference():
    """The trade-off rows exactly (1e-12), the bound rows against the
    reference's Theorem 1 on its own SCA design, and the oracle row's
    rounded fields."""
    for got, want in zip(sca_bench.tradeoff_sweep(),
                         ref_bench.tradeoff_sweep()):
        assert got["bench"] == want["bench"]
        for k in ("noise_var", "tx_var", "bias", "objective"):
            assert abs(got[k] - want[k]) <= 1e-12 * abs(want[k]), k
    ref_prm = ref_bench.make_prm(10, 0)
    designs = {"sca": ref_sca.solve_sca(ref_prm).gamma,
               "zero_bias": ref_theory.zero_bias_gamma(ref_prm)}
    rows = sca_bench.bound_decomposition()
    assert len(rows) == 6
    for row in rows:
        name, _, t = row["bench"][len("bound_"):].rpartition("_T")
        b = ref_theory.theorem1_bound(designs[name], ref_prm, init_gap=5.0,
                                      num_rounds=int(t))
        for k in ("optimization", "variance", "bias", "total"):
            assert abs(row[k] - b[k]) <= 1e-12 * abs(b[k]), (row["bench"], k)
    got, = sca_bench.run(num_seeds=1, sizes=(5,))
    want, = ref_bench.run(num_seeds=1, sizes=(5,))
    assert got["iters_mean"] == want["iters_mean"]
    assert round(got["gap_vs_oracle_max"], 5) == want["gap_vs_oracle_max"]
    assert round(got["objective_vs_zero_bias"], 4) \
        == want["objective_vs_zero_bias"]


# ---------------------------------------------------------------------------
# the single-run API
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return torch_ref.run_reference_population(
        tmp_path_factory.mktemp("server") / "run_fl.npz", rounds=ROUNDS,
        every=EVERY, batch=BATCH, seeds=(0,), parts=("run_fl",))


@pytest.fixture(scope="module")
def task():
    return make_paper_mlp(hidden=16, samples_per_class=40)


@pytest.fixture(scope="module")
def td(task):
    return task.build_data(0)


@pytest.fixture(scope="module")
def world(task):
    w = channel.WirelessConfig(num_devices=10, seed=0)
    dep = channel.deploy(w)
    prm = OTAParams(d=task.param_dim, gmax=10.0, es=w.energy_per_sample,
                    n0=w.noise_psd, gains=dep.gains, sigma_sq=np.zeros(10),
                    eta=0.05, lsmooth=1.0, kappa_sq=4.0)
    return dep, prm, tpc.make_power_control("sca", dep, prm, method="scipy")


@pytest.mark.parametrize("tag,batch,flat", [("minibatch", BATCH, True),
                                            ("full_batch", 0, False)])
def test_run_fl_matches_reference(ref, task, td, tag, batch, flat):
    pc = tpc.scheme_from_jax("sca", torch_ref.prefixed(ref, "scheme0"))
    run = task.run_config(eta=0.05, num_rounds=ROUNDS, eval_every=EVERY,
                          seed=0, batch_size=batch)
    d = torch_ref.prefixed(ref, "run_fl/draws")
    draws = ReplayDraws(d["h"], d["z"], d["idx"] if batch else None,
                        d["coin"], CPU)
    params, hist = server.run_fl(
        task.loss_fn, params_from_jax(torch_ref.prefixed(ref, "params0")),
        pc, ref["gains"], td.train, run, task.make_eval(td, CPU), flat=flat,
        draws=draws, device="cpu")
    for k, v in torch_ref.prefixed(ref, f"run_fl/{tag}/params").items():
        np.testing.assert_allclose(params[k].numpy(), v, **TOL, err_msg=k)
    for k, v in torch_ref.prefixed(ref, f"run_fl/{tag}/traces").items():
        np.testing.assert_allclose(hist.traces[k], v, **TOL, err_msg=k)
    want = torch_ref.prefixed(ref, f"run_fl/{tag}/hist")
    assert [r["round"] for r in hist] == list(want["round"])
    assert [r["active"] for r in hist] == list(want["active"])
    for k in ("acc", "global_loss"):
        np.testing.assert_allclose([r[k] for r in hist], want[k], **TOL)


def test_legacy_minibatches_are_the_references(ref, td):
    x_dev, y_dev = td.train
    rng = np.random.default_rng(0)
    for t in range(ROUNDS):
        xb, yb = server._sample_batches(x_dev, y_dev, BATCH, rng)
        np.testing.assert_array_equal(xb, ref[f"legacy/xb{t}"])
        np.testing.assert_array_equal(yb, ref[f"legacy/yb{t}"])


@pytest.mark.parametrize("batch,flat", [(BATCH, True), (0, False),
                                        (BATCH, False)])
def test_run_fl_is_the_one_cell_fleet(task, td, world, batch, flat):
    dep, _, pc = world
    run = task.run_config(num_rounds=5, eval_every=2, seed=1,
                          batch_size=batch)
    p0, ev = task.init_params(0, CPU), task.make_eval(td, CPU)
    params, hist = server.run_fl(task.loss_fn, p0, pc, dep.gains, td.train,
                                 run, ev, flat=flat, device="cpu")
    res = tdriver.run_fleet(task.loss_fn, p0, [pc], dep.gains, td.train,
                            run, ev, flat=flat, seeds=(1,), device="cpu")
    assert all(torch.equal(params[k], res.params[k][0, 0]) for k in params)
    assert [r["round"] for r in hist] == [t for t, _ in res.evals] \
        == [0, 2, 4]
    for k, v in res.traces.items():
        np.testing.assert_array_equal(hist.traces[k], v[0, 0])
    for r, (_, e) in zip(hist, res.evals):
        assert r["acc"] == float(e["acc"][0, 0]) and r["scheme"] == "sca"
    got, got_hist = server.run_fl_task(task, pc, dep.gains, run,
                                       task_data=td, params=p0, eval_fn=ev,
                                       flat=flat, device="cpu")
    assert all(torch.equal(got[k], params[k]) for k in params)
    assert [r["acc"] for r in got_hist] == [r["acc"] for r in hist]


@pytest.mark.parametrize("fading", [None, "disk_markov"])
def test_legacy_full_batch_is_run_fl(task, td, world, fading):
    """The host loop at full batch (the batch copied host -> device every
    round) is bitwise ``run_fl``, with and without a fading process."""
    dep, prm, pc = world
    proc = None
    if fading is not None:
        sc = scn.get_scenario(fading)
        proc = scn.make_fading_process(scn.realize(sc, seed=0), sc.dynamics)
    run = task.run_config(num_rounds=5, eval_every=2, seed=0, batch_size=0)
    p0, ev = task.init_params(0, CPU), task.make_eval(td, CPU)
    a, ha = server.run_fl(task.loss_fn, p0, pc, dep.gains, td.train, run,
                          ev, fading=proc, device="cpu")
    b, hb = server.run_fl_legacy(task.loss_fn, p0, pc, dep.gains, td.train,
                                 run, ev, fading=proc, device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    for ra, rb in zip(ha, hb):
        for k in ("acc", "global_loss", "round", "active", "scheme"):
            assert ra[k] == rb[k], k
    assert len(ha) == len(hb) == 3
    mb = dataclasses.replace(run, batch_size=BATCH)
    c, hc = server.run_fl_legacy(task.loss_fn, p0, pc, dep.gains, td.train,
                                 mb, ev, fading=proc, device="cpu")
    assert all(torch.isfinite(v).all() for v in c.values())
    assert not all(torch.equal(a[k], c[k]) for k in a)


def test_fig2_benchmark_equivalence(task, world):
    """``fig2.benchmark`` on the shrunk task: the legacy loop and the
    fleet at full batch agree exactly; its walls and speedups are the
    schema's numbers."""
    dep, prm, _ = world
    designs = fig2.make_schemes(task, dep, prm, [n for n in fig2.SCHEMES
                                                 if n != "sca"], device=CPU)
    sca_pc = tpc.make_sca(dep, prm.replace(eta=task.eta_for("sca", 0.05)),
                          method="scipy")
    designs.insert(fig2.SCHEMES.index("sca"), sca_pc)
    rep = fig2.benchmark(num_rounds=4, eval_every=2, batch_size=BATCH,
                         task=task, log=False, designs=designs, device=CPU)
    assert rep["equivalence"]["max_abs_delta"] == {"acc": 0.0,
                                                   "global_loss": 0.0}
    assert set(rep["final_acc"]["legacy"]) == set(fig2.SCHEMES)
    for block in ("wall_s", "speedup"):
        assert all(isinstance(v, float) and v >= 0
                   for v in rep[block].values())
    assert {"legacy_loop_fullbatch", "fleet_fullbatch", "fleet_minibatch",
            "fleet_minibatch_exec"} <= set(rep["wall_s"])


def test_fig2_cli_refusals():
    for argv in (["--population", "100", "--legacy"],
                 ["--bench", "--checkpoint"],
                 ["--legacy", "--uplink", "int8"],
                 ["--legacy", "--unfused"]):
        with pytest.raises(SystemExit):
            fig2.main(argv)


@pytest.mark.parametrize("kw", [dict(uplink_dtype="bf16"),
                                dict(fuse_round=False),
                                dict(checkpoint_path="unused")],
                         ids=["uplink", "unfused", "checkpoint"])
def test_fig2_legacy_refuses_fleet_options(kw):
    with pytest.raises(ValueError, match="legacy loop"):
        fig2.run(num_rounds=1, engine="legacy", save=False, device="cpu",
                 **kw)
