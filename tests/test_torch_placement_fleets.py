"""The sharded placement against the port's vmap placement, on CPU slots.

``fl.placement.ShardedPlacement`` on a 2 x 2 ("data", "model") mesh of
four CPU slots runs every fleet kind through ``fl.driver.run_fleet``: the
plain fleet (3 schemes x 2 seeds: 6 cells pad to 8), a stateful Markov and
a dropout scenario, a population-mode cohort fleet and a cohort grid that
pads 3 cells to 4, and a scenario grid whose blocks cut a scheme's seeds
and a scenario row.  Each is held against the same fleet on the default
``VmapPlacement`` with the reference's tolerance classes
(``tests/test_placement.py``): the key-stream traces (``active_devices``,
``noise_scale``) bitwise, the other traces at rtol 1e-6 / atol 1e-6, the
evals at rtol 1e-5 / atol 3e-3, the params within 1e-6.  Then: kill and
resume on the sharded placement bitwise, a resume on another placement
refused, an ``adaptive_sca`` sharded run killed and resumed with bitwise
designs (one redesign, a small solver budget), ``solve_batch`` sharded
within 1e-7 of the one batch, ``fig2``'s refusals and its placement
benchmark's summary.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import fig2, solvers, validate_bench
from repro_torch.core import channel, power_control as tpc
from repro_torch.core import scenarios as scn
from repro_torch.core.theory import OTAParams
from repro_torch.data import partition, synthetic
from repro_torch.fl import driver as tdriver
from repro_torch.fl.placement import ShardedPlacement, VmapPlacement
from repro_torch.fl.server import FLRunConfig
from repro_torch.kernels import ref as kref
from repro_torch.launch import mesh as tmesh
from repro_torch.models import mlp
from repro_torch.models.param import init_params
from repro_torch.sca_bench import make_prm as solver_prm
from torch_ref import one_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
HIDDEN, D = 32, 10000
EXACT = ("active_devices", "noise_scale")
SMALL = dataclasses.replace(solvers.DEFAULT_CONFIG, max_iters=2,
                            inner_iters=5, polish_adam_iters=5,
                            polish_iters=3)


def _sharded():
    return ShardedPlacement(tmesh.make_debug_mesh(2, 2, slots=[CPU] * 4))


@pytest.fixture(scope="module")
def world():
    dep = channel.deploy(channel.WirelessConfig(num_devices=10, seed=0))
    wcfg = channel.WirelessConfig(num_devices=10, seed=0)
    x, y, xt, yt = synthetic.mnist_like(40, seed=0)
    data = partition.stack_shards(partition.partition_by_label(x, y, 10,
                                                               seed=0))
    prm = OTAParams(d=D, gmax=10.0, es=wcfg.energy_per_sample,
                    n0=wcfg.noise_psd, gains=dep.gains,
                    sigma_sq=np.zeros(10), eta=0.05, lsmooth=1.0,
                    kappa_sq=4.0)
    params0 = init_params(mlp.mlp_defs(hidden=HIDDEN), 0, CPU)
    xt_t, yt_t = torch.as_tensor(xt), torch.as_tensor(yt)

    def ev(p):
        return {"acc": mlp.accuracy(p, xt_t, yt_t)}
    return dep, prm, data, params0, ev


def _scheme(name, dep, prm):
    kw = {"method": "scipy"} if name == "sca" else {}
    return tpc.make_power_control(name, dep, prm, **kw)


def _scenario(name):
    sc = scn.get_scenario(name)
    dep = scn.realize(sc, seed=0)
    prm = scn.make_ota_params(dep, d=D, gmax=10.0, eta=0.05, kappa_sq=4.0)
    return dep, prm, scn.make_fading_process(dep, sc.dynamics)


def _compare(res_v, res_s, exact=EXACT):
    """The reference's tolerance classes, sharded against vmap."""
    assert res_v.names == res_s.names and res_v.seeds == res_s.seeds
    assert set(res_v.traces) == set(res_s.traces)
    for k in res_v.traces:
        if k in exact:
            assert np.array_equal(res_v.traces[k], res_s.traces[k]), k
        else:
            np.testing.assert_allclose(res_s.traces[k], res_v.traces[k],
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    assert [t for t, _ in res_v.evals] == [t for t, _ in res_s.evals]
    for (_, ea), (_, eb) in zip(res_v.evals, res_s.evals):
        for k in ea:
            np.testing.assert_allclose(eb[k], ea[k], rtol=1e-5, atol=3e-3,
                                       err_msg=k)
    for k in res_v.params:
        assert res_v.params[k].shape == res_s.params[k].shape
        assert float((res_v.params[k] - res_s.params[k]).abs().max()) < 1e-6


def _bitwise(a, b):
    """Params, traces, evals, the fading state and the design trace, bit
    for bit (the same placement on both sides)."""
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    assert all(np.array_equal(a.traces[k], b.traces[k]) for k in a.traces)
    assert [t for t, _ in a.evals] == [t for t, _ in b.evals]
    assert all(np.array_equal(ea[k], eb[k])
               for (_, ea), (_, eb) in zip(a.evals, b.evals) for k in ea)
    assert (a.fading_state is None) == (b.fading_state is None)
    if a.fading_state is not None:
        assert torch.equal(a.fading_state, b.fading_state)
    if a.designs is not None:
        assert [t for t, _ in a.designs] == [t for t, _ in b.designs]
        assert all(np.array_equal(ga, gb) for (_, ga), (_, gb)
                   in zip(a.designs, b.designs))


def test_sharded_fleet_matches_vmap(world):
    """[3 schemes x 2 seeds] on a 2 x 2 mesh (6 cells pad to 8), minibatch
    on the fused flat tail: the round tail runs once a slot a round (four
    plain-version calls a round here, one under vmap)."""
    dep, prm, data, params0, ev = world
    schemes = [_scheme(n, dep, prm) for n in ("ideal", "sca", "vanilla")]
    run = FLRunConfig(eta=0.05, num_rounds=9, eval_every=4, batch_size=8)
    kw = dict(seeds=(0, 3), flat=True, device="cpu")
    calls = kref.ota_round_step_ref.calls
    res_v = tdriver.run_fleet(mlp.mlp_loss, params0, schemes, dep.gains,
                              data, run, ev, **kw)
    vmap_calls = kref.ota_round_step_ref.calls - calls
    pl = _sharded()
    res_s = tdriver.run_fleet(mlp.mlp_loss, params0, schemes, dep.gains,
                              data, run, ev, **kw, placement=pl)
    assert vmap_calls == run.num_rounds
    assert kref.ota_round_step_ref.calls - calls - vmap_calls \
        == 4 * run.num_rounds
    assert res_s.traces["active_devices"].shape == (3, 2, run.num_rounds)
    assert res_s.params["w1"].shape[:2] == (3, 2)
    assert pl.describe(cells=6) == "sharded[data=2,model=2,cells=6,pad=2/8]"
    _compare(res_v, res_s)


@pytest.mark.parametrize("name", ["disk_markov", "disk_dropout"])
def test_sharded_fleet_stateful_scenario(name):
    """A Gauss-Markov (and a dropout) fading process: every slot steps the
    whole state, the driver gets it back bitwise the vmap fleet's."""
    dep, prm, fp = _scenario(name)
    x, y, _, _ = synthetic.mnist_like(40, seed=0)
    data = partition.stack_shards(partition.partition_by_label(x, y, 10,
                                                               seed=0))
    params0 = init_params(mlp.mlp_defs(hidden=HIDDEN), 0, CPU)
    schemes = [_scheme(n, dep, prm) for n in ("sca", "zero_bias")]
    run = FLRunConfig(eta=0.05, num_rounds=6, eval_every=3)
    kw = dict(seeds=(0, 1), fading=fp, flat=False, device="cpu")
    res_v = tdriver.run_fleet(mlp.mlp_loss, params0, schemes, dep.gains,
                              data, run, None, **kw)
    res_s = tdriver.run_fleet(mlp.mlp_loss, params0, schemes, dep.gains,
                              data, run, None, **kw, placement=_sharded())
    _compare(res_v, res_s)
    assert torch.equal(res_v.fading_state, res_s.fading_state)


@pytest.mark.parametrize("case", ["cohort_fleet", "cohort_grid_pads"])
def test_sharded_cohort_fleet_matches_vmap(world, case):
    """Population mode: a Rician Gauss-Markov population's cohort fleet
    (2 schemes x 2 seeds fill the four slots) and a grid that pads 3
    cells to 4 with a cohort (10) that does not divide the slot count; the
    host's cohort draws are the same whatever the placement."""
    dep, prm, data, params0, ev = world
    if case == "cohort_fleet":
        spec = scn.PopulationSpec(
            size=120, shadowing=scn.ShadowingSpec(sigma_db=6.0),
            fading=channel.FadingSpec(family="rician", rician_k=3.0),
            dynamics=scn.DynamicsSpec(rho=0.9), sampling="traffic", seed=11)
        names, seeds = ("sca", "ideal"), (0, 1)
    else:
        spec = scn.PopulationSpec(size=23, sampling="traffic", seed=5)
        names, seeds = ("sca", "ideal", "vanilla"), (3,)
    pop = scn.Population(spec=spec)
    schemes = [_scheme(n, dep, prm) for n in names]
    run = FLRunConfig(eta=0.05, num_rounds=5, eval_every=2, batch_size=8)
    kw = dict(seeds=seeds, flat=True, population=pop, cohort_size=10,
              cohort_rounds=2, device="cpu")
    res_v = tdriver.run_fleet(mlp.mlp_loss, params0, schemes, dep.gains,
                              data, run, ev, **kw)
    res_s = tdriver.run_fleet(mlp.mlp_loss, params0, schemes, dep.gains,
                              data, run, ev, **kw, placement=_sharded())
    assert res_s.traces["active_devices"].shape == (len(names), len(seeds),
                                                    run.num_rounds)
    assert len(res_v.cohorts) == len(res_s.cohorts) == 3
    for (ta, ia), (tb, ib) in zip(res_v.cohorts, res_s.cohorts):
        assert ta == tb and np.array_equal(ia, ib)
    _compare(res_v, res_s)


def test_sharded_scenario_grid_cuts_rows():
    """A [3 scenario x 2 scheme x 2 seed] grid over four slots: blocks of
    3 cells, so block 0 ends inside a scheme's seeds and block 1 holds
    cells of two scenario rows; the gradients run per scenario row inside
    a block, and the whole stack's state is stepped on every slot."""
    names = ("disk_rayleigh", "disk_markov", "disk_dropout")
    worlds = [_scenario(n) for n in names]
    stack = scn.stack_deployments([w[0] for w in worlds],
                                  [scn.get_scenario(n).dynamics
                                   for n in names], names=names)
    schemes = [_scheme(s, dep, prm) for dep, prm, _ in worlds
               for s in ("zero_bias", "vanilla")]
    x, y, xt, yt = synthetic.mnist_like(40, seed=0)
    data = partition.stack_shards(partition.partition_by_label(x, y, 10,
                                                               seed=0))
    params0 = init_params(mlp.mlp_defs(hidden=HIDDEN), 0, CPU)
    run = FLRunConfig(eta=0.05, num_rounds=5, eval_every=2, batch_size=8)
    kw = dict(etas=[0.05] * len(schemes), seeds=(0, 1), flat=True,
              scenarios=stack, device="cpu")
    pl = _sharded()
    assert [ids.tolist() for _, ids in pl.blocks(6, 2)] == [
        [0, 1, 2], [3, 4, 5], [6, 7, 8], [9, 10, 11]]
    res_v = tdriver.run_fleet(mlp.mlp_loss, params0, schemes, None, data,
                              run, None, **kw)
    res_s = tdriver.run_fleet(mlp.mlp_loss, params0, schemes, None, data,
                              run, None, **kw, placement=pl)
    _compare(res_v, res_s)
    assert torch.equal(res_v.fading_state, res_s.fading_state)


def test_sharded_resume_bitwise_and_placement_identity(world, tmp_path):
    """Killed after chunk 1 and resumed on the sharded placement: bitwise
    the uninterrupted sharded run.  The checkpoint names its placement: a
    resume under ``VmapPlacement`` raises, as one under another mesh."""
    dep, prm, data, params0, ev = world
    schemes = [_scheme(n, dep, prm) for n in ("sca", "ideal", "vanilla")]
    run = FLRunConfig(eta=0.05, num_rounds=7, eval_every=3, batch_size=8)
    args = (mlp.mlp_loss, params0, schemes, dep.gains, data, run, ev)
    kw = dict(seeds=(0, 2), flat=True, device="cpu", placement=_sharded())
    path = str(tmp_path / "fleet")
    full = tdriver.run_fleet(*args, **kw)
    part = tdriver.run_fleet(*args, **kw, checkpoint_path=path,
                             max_chunks=1)
    assert part.traces["active_devices"].shape[-1] < run.num_rounds
    res = tdriver.run_fleet(*args, **kw, checkpoint_path=path, resume=True)
    _bitwise(full, res)
    with pytest.raises(ValueError, match="placement"):
        tdriver.run_fleet(*args, **dict(kw, placement=VmapPlacement()),
                          checkpoint_path=path, resume=True)
    two = ShardedPlacement(tmesh.make_debug_mesh(2, 1, slots=[CPU] * 2))
    with pytest.raises(ValueError, match="placement"):
        tdriver.run_fleet(*args, **dict(kw, placement=two),
                          checkpoint_path=path, resume=True)


def test_sharded_adaptive_resume_bitwise(tmp_path):
    """``adaptive_sca`` on disk_markov, sharded, one redesign (chunks of
    1 and 3 rounds): killed after chunk 1 and resumed, the params, traces
    and the design trace are bitwise the uninterrupted sharded run's, and
    the redesign read the same state the vmap fleet's read."""
    dep, prm, fp = _scenario("disk_markov")
    pc = tpc.make_adaptive_sca(dep, prm, base=tpc.make_lcpc(dep, prm),
                               cfg=SMALL)
    x, y, _, _ = synthetic.mnist_like(40, seed=0)
    data = partition.stack_shards(partition.partition_by_label(x, y, 10,
                                                               seed=0))
    params0 = init_params(mlp.mlp_defs(hidden=HIDDEN), 0, CPU)
    run = FLRunConfig(eta=0.05, num_rounds=4, eval_every=3, batch_size=8)
    args = (mlp.mlp_loss, params0, [pc], dep.gains, data, run)
    kw = dict(fading=fp, flat=True, seeds=(0, 1), device="cpu",
              placement=_sharded())
    path = str(tmp_path / "fleet")
    full = tdriver.run_fleet(*args, **kw)
    assert [t for t, _ in full.designs] == [0, 1]
    part = tdriver.run_fleet(*args, **kw, checkpoint_path=path,
                             max_chunks=1)
    assert len(part.designs) == 2
    res = tdriver.run_fleet(*args, **kw, checkpoint_path=path, resume=True)
    _bitwise(full, res)
    vmap = tdriver.run_fleet(*args, **dict(kw, placement=None))
    assert np.array_equal(vmap.designs[1][1], full.designs[1][1])
    _compare(vmap, full)


def test_solve_batch_sharded_matches_one_batch():
    """Six rows padded to eight over four slots, one solve a slot, within
    1e-7 of the one batch (a small iteration budget: the rows are
    independent whatever the budget); ``VmapPlacement`` is the one batch,
    bitwise."""
    prms = [solver_prm(6, s) for s in range(6)]
    one = solvers.solve_batch(prms, SMALL, device="cpu")
    got = solvers.solve_batch(prms, SMALL, device="cpu",
                              placement=_sharded())
    for f in ("gamma", "objective", "alpha"):
        np.testing.assert_allclose(getattr(got, f), getattr(one, f),
                                   rtol=1e-7, err_msg=f)
    same = solvers.solve_batch(prms[:2], SMALL, device="cpu",
                               placement=VmapPlacement())
    assert np.array_equal(same.gamma, one.gamma[:2])
    assert np.array_equal(same.objective, one.objective[:2])


def test_fig2_placement_refusals(monkeypatch):
    """``--sharded`` without four slots and ``--coordinator`` without its
    process flags exit with the reference's messages."""
    monkeypatch.delenv(tmesh.SLOTS_ENV, raising=False)
    with pytest.raises(SystemExit, match="needs >= 4 devices"):
        fig2.main(["--sharded", "--device", "cpu", "--rounds", "1"])
    with pytest.raises(SystemExit, match="needs --num-processes"):
        fig2.main(["--coordinator", "127.0.0.1:1", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--sharded applies"):
        fig2.main(["--sharded", "--bench", "--device", "cpu"])
    with pytest.raises(SystemExit, match="drop --legacy/--sharded"):
        fig2.main(["--population", "100", "--sharded", "--device", "cpu"])


def test_placement_benchmark_summary(world, monkeypatch):
    """``placement_benchmark`` at K.S = 3 and 6 with four CPU slots: vmap
    and sharded rows, the K1 count (its plain version here) of each, and
    a summary ``validate_bench`` accepts."""
    from repro_torch import tasks
    monkeypatch.setenv(tmesh.SLOTS_ENV, "4")
    task = tasks.get("paper_mlp", hidden=16, samples_per_class=10)
    dep, prm, _ = fig2.build_world(task, 0)
    pcs = [_scheme(n, dep, prm) for n in ("ideal", "vanilla", "zero_bias")]
    rep = fig2.placement_benchmark(task=task, num_rounds=2, eval_every=2,
                                   batch_size=4, seeds_grid=(1, 2),
                                   log=False, designs=pcs, device="cpu")
    assert [r["cells"] for r in rep["rows"]] == [3, 6]
    for r in rep["rows"]:
        assert r["vmap"]["launches"]["plain_round_step"] == 2
        assert r["sharded"]["launches"]["plain_round_step"] == 8
        assert r["sharded_devices"] == 4
        assert r["placement"].startswith("sharded[data=2,model=2,cells=")
    summary = fig2.bench_summary({"placement": rep}, task.name, "test")
    assert validate_bench.validate_summary(summary) == []
    assert [sorted(r) for r in summary["placement"]["rows"]] == [
        ["cells", "exec_speedup", "sharded_exec_s", "vmap_exec_s"]] * 2
