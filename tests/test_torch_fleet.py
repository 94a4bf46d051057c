"""The port's whole slice against the reference fleet.

``repro_torch.fl.driver.run_fleet`` on the CPU (plain kernel versions),
fed the reference's own draws, the reference's initial params and its
scheme designs, against ``repro.fl.driver.run_fleet_task`` run in a child
process: a shrunk paper_mlp (hidden 16, mnist_like(40), batch 8, 4 rounds,
seeds (0, 1)), all 7 Fig.-2 schemes, minibatch and flat (fused, unfused
and with an int8 uplink), and the paper's full-batch protocol (batch 0,
aggregated leaf by leaf, ``flat=False``), which the reference's
``fig2.run`` runs by default.

Tolerance rtol 1e-4, atol 1e-5 on params, traces and evals: the two sides
run the same f32 arithmetic, but XLA and PyTorch order the sums of the
matmuls, the gradient reductions and the N-device aggregation differently
and XLA's CPU exp/log differ from PyTorch's by an ulp (OPC's grid), so the
trajectories agree to accumulated f32 rounding over 4 rounds, not bitwise.
The int8 uplink adds one more source: a gradient element that lands within
an ulp of a rounding boundary of the quantizer may get the neighbouring
code on the two sides, a change of one quantum (scale/127) in one element.
"""
import numpy as np
import pytest
import torch

import torch_ref
from repro_torch.core import power_control as tpc
from repro_torch.data import partition as tpart, synthetic as tsyn
from repro_torch.fl import driver as tdriver
from repro_torch.fl.draws import DeviceDraws, ReplayDraws, round_seed
from repro_torch.fl.engine import chunk_lengths
from repro_torch.fl.server import FLRunConfig
from repro_torch.models import mlp as tmlp
from repro_torch.models.param import params_from_jax
from repro_torch.tasks.image import make_paper_mlp
from torch_ref import one_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-5)
ROUNDS, EVERY, BATCH, SEEDS = 4, 2, 8, (0, 1)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return torch_ref.run_reference_fleet(
        tmp_path_factory.mktemp("ref") / "fleet.npz", rounds=ROUNDS,
        every=EVERY, batch=BATCH, seeds=SEEDS)


def _port_run(ref, batch_size=BATCH, flat=True, **kw):
    """The port on the reference's draws; full batch (``batch_size=0``)
    replays them without minibatch indices."""
    task = make_paper_mlp(hidden=16, samples_per_class=40)
    td = task.build_data(0)
    schemes = [tpc.scheme_from_jax(n, torch_ref.prefixed(ref, f"scheme/{n}"))
               for n in torch_ref.FIG2_SCHEMES]
    draws = ReplayDraws(ref["draws/h"], ref["draws/z"],
                        ref["draws/idx"] if batch_size else None,
                        ref["draws/coin"], CPU)
    run = task.run_config(num_rounds=ROUNDS, eval_every=EVERY, seed=0,
                          batch_size=batch_size)
    params0 = params_from_jax(torch_ref.prefixed(ref, "params0"))
    return tdriver.run_fleet_task(task, schemes, ref["gains"], run,
                                  task_data=td, params=params0, seeds=SEEDS,
                                  flat=flat, draws=draws, device="cpu", **kw)


@pytest.mark.parametrize("variant,kw", list(torch_ref.FLEET_VARIANTS.items()))
def test_fleet_matches_reference(ref, variant, kw):
    res = _port_run(ref, **kw)
    assert res.names == torch_ref.FIG2_SCHEMES and res.seeds == SEEDS
    want = torch_ref.prefixed(ref, f"{variant}/params")
    for k in ("b1", "b2", "w1", "w2"):
        np.testing.assert_allclose(res.params[k].numpy(), want[k], **TOL,
                                   err_msg=k)
    want = torch_ref.prefixed(ref, f"{variant}/traces")
    assert set(res.traces) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(res.traces[k], v, **TOL, err_msg=k)
    assert [t for t, _ in res.evals] == list(ref[f"{variant}/evals_t"])
    for k, v in torch_ref.prefixed(ref, f"{variant}/evals").items():
        np.testing.assert_allclose(np.stack([ev[k] for _, ev in res.evals]),
                                   v, **TOL, err_msg=k)


def test_fleet_f32_fused_bitwise_unfused(ref):
    """As the reference pins for itself: with an f32 uplink the fused round
    tail is bitwise the unfused flat chain (same expression, same noise)."""
    fused, unfused = _port_run(ref), _port_run(ref, fuse_round=False)
    for k in fused.params:
        assert torch.equal(fused.params[k], unfused.params[k]), k
    for k in fused.traces:
        assert np.array_equal(fused.traces[k], unfused.traces[k]), k


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    task = make_paper_mlp(hidden=16, samples_per_class=40)
    td = task.build_data(0)
    run = FLRunConfig(num_rounds=1, batch_size=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdriver.run_fleet(tmlp.mlp_loss, {}, [], np.ones(10), td.train, run)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdriver.run_fleet_task(task, [], np.ones(10), run, task_data=td)


def test_device_draws_keyed_per_seed_and_round():
    """Production draws depend on (seed, round) only: replaying round t
    gives the same numbers whatever came before, seeds differ, and the
    shapes are the contract's."""
    gains = np.linspace(1e-12, 1e-11, 10)
    mk = (lambda seeds: DeviceDraws(seeds, gains, [3, 5, 7], 4, 40, CPU))
    a, b = mk((0, 1)), mk((0, 1))
    d3 = a(3)
    b(0), b(1)
    e3 = b(3)
    for x, y in zip(d3, e3):
        assert torch.equal(x, y)
    assert d3.h.shape == (2, 10) and d3.h.dtype == torch.complex64
    assert d3.z.shape == (2, 15) and d3.idx.shape == (2, 10, 4)
    assert d3.coin.shape == (2,) and d3.coin.dtype == torch.bool
    assert int(d3.idx.min()) >= 0 and int(d3.idx.max()) < 40
    assert not torch.equal(d3.z[0], d3.z[1])
    assert not torch.equal(a(4).z, d3.z)
    assert round_seed(0, 1) != round_seed(1, 0)
    single = mk((1,))(3)
    assert torch.equal(single.z[0], d3.z[1])


def test_full_batch_draws_have_no_indices():
    d = DeviceDraws((0,), np.ones(4), [6], 0, 40, CPU)(0)
    assert d.idx is None


@pytest.mark.parametrize("case", torch_ref.CHUNK_CASES)
def test_chunk_lengths_match_reference(ref, case):
    want = ref["chunk_lengths/%d-%d-%d" % case].tolist()
    assert chunk_lengths(case[0], case[1], bool(case[2])) == want


def test_default_draws_shared_across_schemes_and_repeatable():
    """The schemes of one seed see one minibatch stream: in round 0 (same
    start params) ideal's and vanilla's per-device gradient norms agree,
    and a second run with the same seed repeats the first bit for bit."""
    x, y, xt, yt = tsyn.mnist_like(40, seed=0)
    data = tpart.stack_shards(tpart.partition_by_label(x, y, 10, seed=0))
    params = make_paper_mlp(hidden=16).init_params(0, CPU)
    schemes = [tpc.Ideal(name="ideal"),
               tpc.VanillaOTA(name="vanilla", bmax=0.003, n0=5e-21)]
    run = FLRunConfig(num_rounds=3, batch_size=8, eta=0.05)
    gains = np.full(10, 1e-12)
    r1 = tdriver.run_fleet(tmlp.mlp_loss, params, schemes, gains, data, run,
                           device="cpu")
    r2 = tdriver.run_fleet(tmlp.mlp_loss, params, schemes, gains, data, run,
                           device="cpu")
    for k in r1.params:
        assert torch.equal(r1.params[k], r2.params[k])
        assert r1.params[k].shape[:2] == (2, 1)
    gn = r1.traces["grad_norm_mean"]
    assert gn.shape == (2, 1, 3) and np.array_equal(gn[0, :, 0], gn[1, :, 0])
