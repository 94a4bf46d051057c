"""The port's twins of the reference's five ``examples/`` scripts
(``repro_torch.examples``), on the CPU at small sizes.

The reference's scripts run their whole body at import, so they are not
called; what they compute deterministically -- the quickstart world, the
(P1) theory rows of a design, the SLSQP oracle's objective, the scenario
deployments -- is computed by the reference's own modules in a child
process (``torch_ref.run_reference_examples``) on the port's designs and
held at the theory tests' 1e-9 relative; the port's batched designs are
held within 1e-3 of the reference's SLSQP objective (the reference smoke's
solver gate).  Only ``sca_power_control`` solves with the torch solver
(~9 s on this CPU); the other examples take the SLSQP oracle's ``sca``
designs.
"""

import numpy as np
import pytest
import torch

from repro_torch import run, tasks
from repro_torch.core import power_control as pcm
from repro_torch.examples import (quickstart, sca_power_control,
                                  scenario_sweep, serve_decode,
                                  train_fl_transformer)
from repro_torch.launch import train
from repro_torch.models import mlp
from repro_torch.models.param import param_count
import torch_ref
from torch_ref import one_thread  # noqa: F401 (autouse)

RTOL = 1e-9                       # test_torch_solvers.py's THEORY_RTOL
GAP = 1e-3                        # the reference smoke's solver gate
CUT = dict(hidden=16, samples_per_class=20)
PC_SEEDS, PC_N = (0, 1), 10
SCN = ("disk_rayleigh", "two_cluster")
SCN_D = param_count(mlp.mlp_defs(hidden=16))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


@pytest.fixture(scope="module")
def quick():
    task = tasks.get("paper_mlp", expect_runtime="fleet", **CUT)
    dep, prm = quickstart.world(task)
    pcs = quickstart.schemes(dep, prm, "cpu", names=("ideal", "vanilla"))
    pcs.insert(1, pcm.make_sca(dep, prm, method="scipy"))
    return task, dep, prm, pcs


@pytest.fixture(scope="module")
def power_control():
    with pytest.MonkeyPatch.context() as mp:       # the batch cut
        mp.setattr(sca_power_control, "SEEDS", PC_SEEDS)
        return sca_power_control.main(["--device", "cpu"])


@pytest.fixture(scope="module")
def scn_designs():
    return {n: pcm.make_sca(*scenario_sweep.scenario_world(n, SCN_D)[1:],
                            method="scipy") for n in SCN}


@pytest.fixture(scope="module")
def reference(tmp_path_factory, quick, power_control, scn_designs):
    task, _, _, pcs = quick
    cfg = {"sca_power_control": {
               "seeds": list(PC_SEEDS), "n": PC_N, "d": sca_power_control.D,
               "gammas": power_control["result"].gamma.tolist()},
           "quickstart": {"num_devices": task.num_devices,
                          "d": task.param_dim,
                          "gmax": float(task.defaults["gmax"]),
                          "gamma": np.asarray(pcs[1].gamma).tolist()},
           "scenarios": {"d": SCN_D, "gammas": {
               n: np.asarray(pc.gamma).tolist()
               for n, pc in scn_designs.items()}}}
    return torch_ref.run_reference_examples(
        tmp_path_factory.mktemp("ref") / "examples.json", cfg)


def test_quickstart_world_and_sca_match_reference(quick, reference):
    task, dep, prm, pcs = quick
    want = reference["quickstart"]
    assert np.array_equal(dep.gains, want["gains"])
    assert np.array_equal(dep.distances, want["distances"])
    assert (prm.es, prm.n0, prm.d, prm.eta) == (want["es"], want["n0"],
                                                task.param_dim, 0.05)
    from repro_torch.core import theory
    assert _rel(theory.p1_objective(pcs[1].gamma, prm),
                want["sca"]["objective"]) <= RTOL
    assert abs(theory.p1_objective(pcs[1].gamma, prm)
               / want["oracle_objective"] - 1.0) <= GAP


def test_quickstart_fleet_and_grid(quick):
    task, dep, prm, pcs = quick
    td = task.build_data(0)
    run_cfg = task.run_config(num_rounds=4, eval_every=2, batch_size=8)
    res = quickstart.train(task, pcs, dep, run_cfg, td, "cpu")
    assert res.names == quickstart.NAMES
    assert [t for t, _ in res.evals] == [0, 2, 3]
    assert res.traces["active_devices"].shape == (3, 1, 4)
    grid = quickstart.train(task, pcs, dep, run_cfg, td, "cpu",
                            seeds=quickstart.GRID_SEEDS)
    final = np.asarray(grid.evals[-1][1]["acc"])
    assert final.shape == (3, 2) and np.all(np.isfinite(final))
    # seed 0 of the grid is the one-seed fleet, bitwise
    assert all(torch.equal(grid.params[k][:, :1], res.params[k])
               for k in res.params)


def test_quickstart_main_end_to_end(quick, monkeypatch, capsys):
    task, dep, prm, pcs = quick
    monkeypatch.setitem(quickstart.DEMO, "paper_mlp",
                        dict(overrides=CUT, rounds=4, every=2, batch=8))
    out = quickstart.main(["--device", "cpu"],
                          designs=run.Made((prm,), pcs, 0.0))
    text = capsys.readouterr().out
    assert "sca      acc:" in text and "grid vmapped on 1 device" in text
    assert out["grid"].evals[-1][1]["acc"].shape == (3, 2)
    with pytest.raises(ValueError, match="another world"):
        quickstart.main(["--device", "cpu"], designs=run.Made(
            (prm.replace(eta=0.06),), pcs, 0.0))


def test_sca_power_control_rows_match_reference(power_control, reference):
    got, want = power_control, reference["sca_power_control"]
    for r, w, obj in zip(got["rows"], want, got["result"].objective):
        for k in ("bias", "p_spread"):
            assert _rel(r[k], w[k]) <= RTOL, k
        assert _rel(r["objective"], w["objective"]) <= 1e-6
        prm = got["prms"][0]
        scale = 2 * prm.eta * prm.lsmooth
        assert _rel(r["variance"], scale * w["variance"]) <= RTOL
        assert _rel(r["noise_var"], 2 * prm.eta * w["noise"]) <= RTOL
        assert _rel(r["tx_var"], 2 * prm.eta * w["transmission"]) <= RTOL
        assert abs(obj / w["oracle_objective"] - 1.0) <= GAP
    assert _rel(got["oracle"], want[0]["oracle_objective"]) <= RTOL
    comp = got["comparison"]
    for name, key in (("zero-bias", "zero_bias"), ("max-power", "max_power")):
        for k, wk in (("obj", "objective"), ("noise", "noise"),
                      ("tx_var", "transmission"), ("bias", "bias")):
            assert _rel(comp[name][k], want[0][key][wk]) <= RTOL, (name, k)


def test_scenario_sweep_theory_rows_match_reference(scn_designs, reference):
    rows = scenario_sweep.theory_rows(SCN, d=SCN_D, designs=scn_designs)
    assert [r["scenario"] for r in rows] == list(SCN)
    for r in rows:
        w = reference["scenarios"][r["scenario"]]
        assert r["fading"] == w["fading"]
        for k in ("bias", "variance", "objective", "gain_spread_db"):
            assert _rel(r[k], w[k]) <= RTOL, (r["scenario"], k)
        assert abs(w["objective"] / w["oracle_objective"] - 1.0) <= GAP


def test_scenario_sweep_trains_on_each_fading_process(scn_designs):
    hists = scenario_sweep.train(SCN, samples_per_class=20, hidden=16,
                                 rounds=4, every=2, device="cpu",
                                 designs=scn_designs)
    assert list(hists) == list(SCN)
    for h in hists.values():
        assert [r["round"] for r in h] == [0, 2, 3]
        assert all(np.isfinite(r["acc"]) for r in h)
        assert h.traces["grad_norm_mean"].shape == (4,)


def test_serve_decode_runs_the_three_families(capsys):
    out = serve_decode.main(["--device", "cpu"])
    assert list(out) == list(serve_decode.ARCHS)
    for arch, res in out.items():
        assert tuple(res.tokens.shape) == (2, 16)
        assert bool(torch.isfinite(res.logits).all())
        assert res.stats["batch"] == 2 and res.stats["prompt_len"] == 32
    assert capsys.readouterr().out.count("=== ") == 3


def test_train_fl_transformer_argv_is_the_reference_preset():
    assert train_fl_transformer.train_argv() == [
        "--arch", "qwen1.5-0.5b", "--smoke", "--d-model", "512", "--layers",
        "8", "--steps", "200", "--seq", "128", "--clients", "4", "--scheme",
        "sca", "--eta", "0.05", "--log-every", "10"]
    full = train_fl_transformer.train_argv(full=True)
    assert full[full.index("--d-model") + 1] == "768"
    assert full[full.index("--layers") + 1] == "12"
    assert full[full.index("--steps") + 1] == "300"


def _cut(argv: list) -> list:
    """The preset's argv with the model cut to d_model 64, 2 layers."""
    argv = list(argv)
    argv[argv.index("--d-model") + 1] = "64"
    argv[argv.index("--layers") + 1] = "2"
    return argv


def test_train_fl_transformer_loss_falls(capsys, monkeypatch):
    kw = train.parse_args(_cut(train_fl_transformer.train_argv(steps=50))
                          + ["--device", "cpu"])
    dep, prm = train.world(kw["clients"], _num_params(kw), kw["eta"])
    design = train.TrainDesign(prm, pcm.make_sca(dep, prm, method="scipy"),
                               0.0)
    launched, real = [], train.main

    def cut_main(argv):
        launched.append(argv)
        return real(_cut(argv), design=design)
    monkeypatch.setattr(train, "main", cut_main)
    res = train_fl_transformer.main(["--steps", "50", "--device", "cpu"])
    assert launched == [train_fl_transformer.train_argv(steps=50)
                        + ["--device", "cpu"]]
    assert len(res.losses) == 50
    assert "OK: loss improved" in capsys.readouterr().out


def _num_params(kw: dict) -> int:
    from repro_torch import tasks as tk
    t = tk.get(kw["task"], expect_runtime="steps", arch=kw["arch"],
               smoke=kw["smoke"], d_model=kw["d_model"],
               n_layers=kw["n_layers"], seq=kw["seq"], clients=kw["clients"],
               per_client_batch=kw["per_client_batch"], device="cpu")
    return t.param_dim


def test_check_losses_is_the_reference_check():
    assert train_fl_transformer.check_losses(
        list(np.linspace(3.0, 1.0, 60))).startswith("OK")
    with pytest.raises(AssertionError):
        train_fl_transformer.check_losses(list(np.linspace(1.0, 3.0, 60)))
    assert train_fl_transformer.check_losses([3.0, 2.0]).startswith("short")
