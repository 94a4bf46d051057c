"""The port's fleets on scenario worlds: the [scenario x scheme x seed]
grid (``run_fleet(scenarios=...)``), fleets on a fading process
(``run_fleet(fading=...)``) with the dropout-aware schemes, the adaptive
scheme's redesign between chunks, kill and resume, and the refusals.

Against the reference (``repro.fl.driver.run_fleet_task`` in a child
process, ``tests/torch_ref.py::run_reference_scenario_fleets``): a shrunk
paper_mlp (hidden 16, mnist_like(40), minibatch 8, 4 rounds, seeds (0, 1)),
fed the reference's own per-row channel [T, R, S, N], noise and minibatch
draws, its initial params and its designs.  Tolerance rtol 1e-4, atol
1e-5 on params, traces and evals, as ``test_torch_fleet.py``: the two
sides order the f32 sums of the matmuls, the gradient reductions and the
N-device aggregation differently, so the trajectories agree to
accumulated f32 rounding, not bitwise.

The port against itself: grid cells, resumed runs and the i.i.d.
Rayleigh process bitwise.
"""
import dataclasses

import numpy as np
import pytest
import torch

import torch_ref
from repro_torch import scenario_sweep as ss
from repro_torch import solvers
from repro_torch.core import power_control as tpc
from repro_torch.core import scenarios as scn
from repro_torch.fl import driver as tdriver
from repro_torch.fl.draws import ReplayDraws
from repro_torch.fl.engine import make_gradients
from repro_torch.models.param import params_from_jax
from repro_torch.tasks.image import make_paper_mlp

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-5)
ROUNDS, EVERY, BATCH, SEEDS = 4, 2, 8, (0, 1)
GRID = torch_ref.SCN_GRID_TEST
SMALL = dataclasses.replace(solvers.DEFAULT_CONFIG, max_iters=2,
                            inner_iters=5, polish_adam_iters=5,
                            polish_iters=3)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return torch_ref.run_reference_scenario_fleets(
        tmp_path_factory.mktemp("grid") / "fleets.npz", rounds=ROUNDS,
        every=EVERY, batch=BATCH, seeds=SEEDS)


@pytest.fixture(scope="module")
def task():
    return make_paper_mlp(hidden=16, samples_per_class=40)


@pytest.fixture(scope="module")
def td(task):
    return task.build_data(0)


def _run(task, rounds=ROUNDS, every=EVERY):
    return task.run_config(eta=0.05, num_rounds=rounds, eval_every=every,
                           seed=0, batch_size=BATCH)


def _ref_schemes(ref, tag):
    n = len({k.split("/")[1] for k in ref if k.startswith(tag + "/scheme")})
    return [tpc.scheme_from_jax(str(ref[f"{tag}/scheme{i}/name"]),
                                torch_ref.prefixed(ref, f"{tag}/scheme{i}"))
            for i in range(n)]


def _replay(ref, h, batch=BATCH):
    """The reference's draws; a full-batch round (``batch`` 0) takes no
    minibatch indices."""
    return ReplayDraws(h, ref["draws/z"], ref["draws/idx"] if batch else None,
                       ref["draws/coin"], CPU)


def _assert_matches(res, ref, tag):
    want = torch_ref.prefixed(ref, f"{tag}/params")
    for k in ("b1", "b2", "w1", "w2"):
        np.testing.assert_allclose(res.params[k].numpy(), want[k], **TOL,
                                   err_msg=k)
    want = torch_ref.prefixed(ref, f"{tag}/traces")
    assert set(res.traces) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(res.traces[k], v, **TOL, err_msg=k)
    assert [t for t, _ in res.evals] == list(ref[f"{tag}/evals_t"])
    for k, v in torch_ref.prefixed(ref, f"{tag}/evals").items():
        np.testing.assert_allclose(np.stack([ev[k] for _, ev in res.evals]),
                                   v, **TOL, err_msg=k)


@pytest.mark.parametrize("tag,batch", [("grid", BATCH),
                                       ("grid_full_batch", 0)])
def test_grid_matches_reference(ref, task, td, tag, batch):
    """The grid of four scenarios (i.i.d. Rayleigh, Rician, Nakagami and
    urban_canyon's Gauss-Markov Rician with dropout) x (sca, lcpc,
    zero_bias) x 2 seeds on the reference's per-row channel, minibatch
    and at full batch (the card's protocol)."""
    schemes = _ref_schemes(ref, "grid")
    run = dataclasses.replace(_run(task), batch_size=batch)
    res = tdriver.run_fleet_task(
        task, schemes, None, run, task_data=td,
        params=params_from_jax(torch_ref.prefixed(ref, "params0")),
        seeds=SEEDS, flat=True, etas=[0.05] * len(schemes),
        draws=_replay(ref, ref["grid/h"], batch),
        scenarios=scn.stack_scenarios(GRID, seed=0), device="cpu")
    assert res.names == tuple(str(n) for n in ref["grid/names"])
    assert res.scenario_names == GRID
    _assert_matches(res, ref, tag)


@pytest.mark.parametrize("name", torch_ref.SCN_FLEET_TEST)
def test_dropout_fleet_matches_reference(ref, task, td, name):
    """A fleet of the seven Fig.-2 schemes on a dropout scenario's process
    (disk_dropout: i.i.d.; urban_canyon: Gauss-Markov Rician): vanilla,
    opc and both bbfl are dropout-aware, as the reference builds them."""
    sc = scn.get_scenario(name)
    dep = scn.realize(sc, seed=0)
    schemes = _ref_schemes(ref, name)
    assert [pc.dropout_aware for pc in schemes
            if hasattr(pc, "dropout_aware")] == [True] * 4
    res = tdriver.run_fleet_task(
        task, schemes, dep.gains, _run(task), task_data=td,
        params=params_from_jax(torch_ref.prefixed(ref, "params0")),
        seeds=SEEDS, flat=True, etas=[0.05] * len(schemes),
        draws=_replay(ref, ref[name + "/h"]),
        fading=scn.make_fading_process(dep, sc.dynamics), device="cpu")
    _assert_matches(res, ref, name)
    assert bool((res.traces["active_devices"] < 10).any())


def _world(task, names=GRID):
    return ss.design(names, schemes=("lcpc", "zero_bias"),
                     d=task.param_dim, device="cpu")


def _kw(task, td):
    return dict(task_data=td, params=task.init_params(0, CPU),
                eval_fn=task.make_eval(td, CPU), device=CPU)


def test_grid_cells_are_scenario_fleets_bitwise(task, td):
    """Cell (r, k, s) of the grid is the (k, s) cell of scenario r's own
    fleet, bit for bit, and the R = 1 grid is that fleet."""
    world, kw, run = _world(task), _kw(task, td), _run(task)
    grid = ss.grid_fleet(task, world, GRID, run, SEEDS, **kw)
    assert grid.params["w1"].shape[:2] == (len(GRID) * 2, len(SEEDS))
    assert grid.fading_state.shape == (len(GRID), len(SEEDS), 10)
    assert grid.names[:2] == ("disk_rayleigh/lcpc", "disk_rayleigh/zero_bias")
    for r, name in enumerate(GRID):
        fleet = ss.scenario_fleet(task, world, name, run, SEEDS, **kw)
        assert ss.bitwise(grid, fleet, slice(2 * r, 2 * r + 2)), name
        assert torch.equal(grid.fading_state[r], fleet.fading_state[0])
    one = ss.grid_fleet(task, world, GRID[:1], run, SEEDS, **kw)
    assert ss.bitwise(one, ss.scenario_fleet(task, world, GRID[0], run,
                                             SEEDS, **kw))


@pytest.mark.parametrize("rows", [2, 4])
def test_gradients_by_scenario_rows(task, td, rows):
    """The gradients of C cells taken ``rows`` blocks at a time are the
    single vmap's over all C cells within f32 rounding (the blocks' GEMMs
    have other shapes: rtol 1e-5, atol 1e-7), and each block is bitwise the
    single vmap of that block alone."""
    grads = make_gradients(task.loss_fn, _run(task))
    x = torch.as_tensor(td.train[0], dtype=torch.float32)
    y = torch.as_tensor(td.train[1]).long()
    c = 8
    gen = torch.Generator().manual_seed(3)
    params = {k: v[None] + 0.01 * torch.randn((c,) + tuple(v.shape),
                                               generator=gen)
              for k, v in task.init_params(0, CPU).items()}
    cell_seed = torch.arange(c) % 2
    split, norms = grads(params, x, y, None, cell_seed, rows)
    whole, whole_norms = grads(params, x, y, None, cell_seed)
    torch.testing.assert_close(norms, whole_norms, rtol=1e-5, atol=1e-7)
    for k in whole:
        torch.testing.assert_close(split[k], whole[k], rtol=1e-5, atol=1e-7)
    per = c // rows
    for r in range(rows):
        cells = slice(r * per, (r + 1) * per)
        alone, _ = grads({k: v[cells] for k, v in params.items()}, x, y,
                         None, cell_seed[cells])
        assert all(torch.equal(split[k][cells], alone[k]) for k in alone)


def test_rayleigh_process_fleet_is_the_paper_fleet_bitwise(task, td):
    world, kw, run = _world(task, ("disk_rayleigh",)), _kw(task, td), \
        _run(task)
    w = world["disk_rayleigh"]
    plain = tdriver.run_fleet_task(task, w["schemes"], w["dep"].gains, run,
                                   seeds=SEEDS, flat=True, **kw)
    proc = ss.scenario_fleet(task, world, "disk_rayleigh", run, SEEDS, **kw)
    assert ss.bitwise(proc, plain) and plain.fading_state is None


def _adaptive(fading_name="disk_markov"):
    sc = scn.get_scenario(fading_name)
    dep = scn.realize(sc, seed=0)
    prm = scn.make_ota_params(dep, d=make_paper_mlp(hidden=16).param_dim,
                              gmax=10.0, eta=0.05, kappa_sq=4.0)
    pc = tpc.make_adaptive_sca(dep, prm, base=tpc.make_lcpc(dep, prm),
                               cfg=SMALL)
    return pc, dep, scn.make_fading_process(dep, sc.dynamics)


def test_adaptive_fleet_redesigns_between_chunks(task, td):
    """An adaptive fleet re-designs at every chunk boundary (the eval
    cadence, even without an eval: rounds 1 and 3 of 5), each seed row
    from its own state, into leaves [S, N]; on a static process the design
    never moves."""
    pc, dep, fp = _adaptive()
    run = _run(task, rounds=5)
    res = tdriver.run_fleet(task.loss_fn, task.init_params(0, CPU), [pc],
                            dep.gains, td.train, run, seeds=SEEDS,
                            fading=fp, device="cpu")
    assert [t for t, _ in res.designs] == [0, 1, 3]
    g = [gam for _, gam in res.designs]
    assert all(x.shape == (1, len(SEEDS), 10) for x in g)
    assert np.array_equal(g[0][0, 0], g[0][0, 1])
    assert not np.array_equal(g[1][0, 0], g[1][0, 1])
    assert not np.array_equal(g[1], g[2])
    pc0, dep0, fp0 = _adaptive("disk_rayleigh")
    static = tdriver.run_fleet(task.loss_fn, task.init_params(0, CPU),
                               [pc0], dep0.gains, td.train, run,
                               seeds=SEEDS, fading=fp0, device="cpu")
    assert all(np.array_equal(x, static.designs[0][1])
               for _, x in static.designs)
    plain = tdriver.run_fleet(task.loss_fn, task.init_params(0, CPU), [pc],
                              dep.gains, td.train, run, seeds=SEEDS,
                              device="cpu")
    assert plain.designs is None


def _fleet(kind, task, td):
    """(a run(**kw) of the fleet ``kind``, its round count)."""
    kw, run = _kw(task, td), _run(task, rounds=7, every=3)
    if kind == "disk_markov":
        world = _world(task, ("disk_markov",))
        return lambda **k: ss.scenario_fleet(task, world, "disk_markov", run,
                                             SEEDS, **kw, **k)
    if kind == "adaptive":
        pc, dep, fp = _adaptive()
        return lambda **k: tdriver.run_fleet_task(
            task, [pc], dep.gains, run, seeds=SEEDS, fading=fp, flat=True,
            etas=[0.05], **kw, **k)
    world = _world(task)
    return lambda **k: ss.grid_fleet(task, world, GRID, run, SEEDS, **kw,
                                     **k)


@pytest.mark.parametrize("kind", ["disk_markov", "adaptive", "grid"])
def test_kill_and_resume_bitwise(task, td, tmp_path, kind):
    """Stopped after its first chunk and resumed from the checkpoint, the
    fleet ends bitwise equal to an uninterrupted run: params, traces,
    evals, the fading state and an adaptive fleet's design trace."""
    fleet = _fleet(kind, task, td)
    whole = fleet()
    path = str(tmp_path / "ck")
    first = fleet(checkpoint_path=path, max_chunks=1)
    rest = fleet(checkpoint_path=path, resume=True)
    assert sum(n for n, _ in first.chunk_walls) < 7
    assert sum(n for n, _ in first.chunk_walls) \
        + sum(n for n, _ in rest.chunk_walls) == 7
    assert ss.bitwise(rest, whole)
    assert torch.equal(rest.fading_state, whole.fading_state)
    assert [t for t, _ in rest.evals] == [t for t, _ in whole.evals]
    for (_, a), (_, b) in zip(rest.evals, whole.evals):
        assert all(np.array_equal(a[k], b[k]) for k in a)
    if kind == "adaptive":
        assert [t for t, _ in rest.designs] == [t for t, _ in whole.designs]
        assert all(np.array_equal(a, b) for (_, a), (_, b)
                   in zip(rest.designs, whole.designs))


def test_resume_refuses_another_scenario_axis(task, td, tmp_path):
    world, kw, run = _world(task), _kw(task, td), _run(task)
    path = str(tmp_path / "ck")
    ss.grid_fleet(task, world, GRID, run, SEEDS, checkpoint_path=path,
                  max_chunks=1, **kw)
    swapped = (GRID[1], GRID[0]) + GRID[2:]
    with pytest.raises(ValueError, match="does not match"):
        ss.grid_fleet(task, world, swapped, run, SEEDS,
                      checkpoint_path=path, resume=True, **kw)


@pytest.mark.parametrize("case", ["gains", "fading", "adaptive",
                                  "not_a_multiple", "device_count",
                                  "mixed_adaptive"])
def test_refusals(task, td, case):
    world = _world(task, GRID[:2])
    stack = scn.stack_scenarios(GRID[:2])
    schemes = [pc for n in GRID[:2] for pc in world[n]["schemes"]]
    pc, dep, fp = _adaptive()
    kw = dict(task_data=td, device="cpu")
    run = _run(task)
    args = {"gains": dict(gains=dep.gains, scenarios=stack),
            "fading": dict(fading=fp, scenarios=stack),
            "adaptive": dict(schemes=[pc, pc], scenarios=stack),
            "not_a_multiple": dict(schemes=schemes[:3], scenarios=stack),
            "device_count": dict(scenarios=scn.stack_deployments(
                [dataclasses.replace(world[n]["dep"],
                                     gains=world[n]["dep"].gains[:9])
                 for n in GRID[:2]])),
            "mixed_adaptive": dict(schemes=[pc, schemes[0]],
                                   gains=dep.gains, fading=fp)}
    a = dict(schemes=schemes, gains=None)
    a.update(args[case])
    with pytest.raises(ValueError):
        tdriver.run_fleet_task(task, a.pop("schemes"), a.pop("gains"), run,
                               **a, **kw)


def test_gate_false_alarm_rates():
    """The grid gate's false-alarm rates on the reference's committed
    histories: rates are shares, the chance of some miss is at least the
    largest single rate and falls from four seeds a side to eight, and a
    floor-bound comparison (final loss: 2 % of the loss against an SD two
    orders smaller) never misses.  2,000 trials, seeded: exact."""
    ref = ss.load_reference(ss.GATE_SEEDS)
    four = ss.gate_false_alarm(ref, 4, trials=2000)
    eight = ss.gate_false_alarm(ref, 8, trials=2000)
    assert len(four["per_comparison"]) == 36
    for fa in (four, eight):
        rates = fa["per_comparison"].values()
        assert all(0.0 <= r <= 1.0 for r in rates)
        assert max(rates) <= fa["any"] <= 1.0
    assert eight["any"] < four["any"]
    assert four == ss.gate_false_alarm(ref, 4, trials=2000)
    assert four["per_comparison"]["disk_rayleigh/sca/final_loss"] == 0.0
