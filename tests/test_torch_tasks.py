"""The port's task registry (``repro_torch.tasks``) against the
reference's (``repro.tasks``, read in a child process), the Fig.-2 entry
point's ``--task``, and the curve gate of ``repro_torch.curves`` on
synthetic histories, and the committed reference data the card reads."""
import json

import numpy as np
import pytest

import torch_ref
from repro_torch import curves, fig2, tasks
from repro_torch.tasks import registry


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return torch_ref.run_reference_tasks(
        tmp_path_factory.mktemp("tasks") / "tasks.json")


def test_names_cover_the_reference(ref):
    """Every task the reference registers is ported or named as not ported
    (with where ROADMAP queues it)."""
    assert tasks.names() == ("cifar_conv", "paper_mlp")
    assert set(tasks.names()) | set(registry.NOT_PORTED) == set(ref["names"])
    assert set(tasks.names(runtime="fleet")) <= set(ref["fleet"])
    assert tasks.names(runtime="steps") == ()


def test_paper_mlp_matches_reference(ref):
    t = tasks.get("paper_mlp", expect_runtime="fleet")
    want = ref["paper_mlp"]
    assert t.name == "paper_mlp" and t.runtime == want["runtime"] == "fleet"
    assert t.num_devices == want["num_devices"]
    assert t.param_dim == want["param_dim"] == 814_090
    assert t.defaults == want["defaults"]
    assert t.scheme_etas == want["scheme_etas"]
    assert tasks.get("paper_mlp", hidden=16).param_dim \
        == ref["paper_mlp_small"]


def test_cifar_conv_matches_reference(ref):
    t = tasks.get("cifar_conv", expect_runtime="fleet")
    want = ref["cifar_conv"]
    assert t.name == "cifar_conv" and t.runtime == want["runtime"] == "fleet"
    assert t.num_devices == want["num_devices"]
    assert t.param_dim == want["param_dim"] == 268_650
    assert t.defaults == want["defaults"]
    assert t.scheme_etas == want["scheme_etas"]
    assert t.artifact_tag == want["artifact_tag"] == "cifar"
    assert tasks.get("cifar_conv", **torch_ref.CIFAR_SMOKE_KW).param_dim \
        == ref["cifar_conv_small"]
    assert fig2.artifact_dir(t).name == "cifar"
    assert fig2.default_batch(t) == 32
    assert fig2.default_batch(tasks.get("paper_mlp")) == fig2.BENCH_BATCH


@pytest.mark.parametrize("name", sorted(registry.NOT_PORTED))
def test_unported_task_names_roadmap(name):
    with pytest.raises(KeyError, match="ROADMAP"):
        tasks.get(name)


@pytest.mark.parametrize("call,err,match", [
    (lambda: tasks.get("nope"), KeyError, "unknown task"),
    (lambda: tasks.get("paper_mlp", expect_runtime="steps"), ValueError,
     "fleet"),
    (lambda: tasks.register("paper_mlp", tasks.make_paper_mlp), ValueError,
     "already registered"),
    (lambda: tasks.get("paper_mlp", no_such_override=1), TypeError, None),
])
def test_registry_errors(call, err, match):
    with pytest.raises(err, match=match):
        call()


def test_factory_must_build_its_name():
    registry.register("misnamed_for_test", tasks.make_paper_mlp)
    try:
        with pytest.raises(ValueError, match="built task"):
            tasks.get("misnamed_for_test")
    finally:
        del registry._FACTORIES["misnamed_for_test"]


@pytest.mark.parametrize("name", ["token_stream", "nope"])
def test_fig2_cli_refuses_unknown_task(name):
    with pytest.raises(SystemExit, match=name):
        fig2.main(["--task", name, "--device", "cpu"])


# --- the curve gate on synthetic histories --------------------------------

def _hist(final_acc, final_loss, mean_shift=0.0, schemes=("ideal", "sca"),
          n_evals=16, first_round=0):
    acc = np.linspace(0.1, final_acc, n_evals) + mean_shift
    acc[-1] = final_acc
    return {s: [{"acc": float(a), "global_loss": float(final_loss),
                 "round": first_round + i} for i, a in enumerate(acc)]
            for s in schemes}


REF = [_hist(0.95 + 0.002 * s, 5.0 + 0.01 * s) for s in range(4)]


@pytest.mark.parametrize("case,port,ok", [
    ("same", [_hist(0.95 + 0.002 * s, 5.0 + 0.01 * s) for s in range(4)],
     True),
    ("within_floor", [_hist(0.957, 5.09) for _ in range(4)], True),
    ("acc_off", [_hist(0.93, 5.0) for _ in range(4)], False),
    ("loss_off", [_hist(0.95, 5.2) for _ in range(4)], False),
    ("mean_acc_off", [_hist(0.95, 5.0, mean_shift=-0.05) for _ in range(4)],
     False),
    ("scheme_missing", [_hist(0.95, 5.0, schemes=("ideal",))
                        for _ in range(4)], False),
    ("one_seed_missing_a_scheme", [_hist(0.95, 5.0) for _ in range(3)]
     + [_hist(0.95, 5.0, schemes=("ideal",))], False),
    ("other_cadence", [_hist(0.95, 5.0, n_evals=31) for _ in range(4)],
     False),
    ("other_rounds", [_hist(0.95, 5.0, first_round=50) for _ in range(4)],
     False),
    ("no_port_runs", [], False),
])
def test_curve_gate(case, port, ok):
    rows = curves.gate(port, REF)
    assert len(rows) == 2 * len(curves.STATS)
    assert all(r["ok"] for r in rows) == ok, curves.table(rows)
    assert "FAIL" in curves.table(rows) or ok


def test_curve_gate_bound_widens_with_the_spread():
    """With a seed-to-seed spread the bound is 3 standard errors of the
    difference of the means, past the floor."""
    port = [_hist(0.90 + 0.04 * s, 5.0) for s in range(4)]
    rows = {(r["scheme"], r["stat"]): r for r in curves.gate(port, REF)}
    r = rows[("sca", "final_acc")]
    sd_p = np.std([0.90 + 0.04 * s for s in range(4)], ddof=1)
    sd_r = np.std([0.95 + 0.002 * s for s in range(4)], ddof=1)
    assert r["bound"] == pytest.approx(3 * np.sqrt(sd_p**2 / 4 + sd_r**2 / 4))
    assert r["bound"] > curves.ACC_FLOOR and r["ok"]
    assert rows[("sca", "final_loss")]["bound"] == pytest.approx(
        curves.LOSS_FLOOR_SHARE * np.mean([5.0 + 0.01 * s for s in range(4)]))


def test_reference_curves_are_committed():
    """The reference's curves the card's gate reads: both protocols, seeds
    0-3 (and 4-7 for the wider check), 16 eval points of the seven Fig.-2
    schemes."""
    for protocol in curves.PROTOCOLS:
        hists = curves.load_reference(protocol, range(8))
        for h in hists:
            assert tuple(h) == tuple(fig2.SCHEMES)
            for rows in h.values():
                assert [r["round"] for r in rows] == list(range(0, 150, 10)) \
                    + [149]
        assert all(r["ok"] for r in curves.gate(hists, hists))


def test_cifar_reference_is_committed():
    """The reference's cifar_conv data the card's phase 11 reads: its sca
    design at d = 268,650, and its curves at minibatch 32, seeds 0-7, 16
    eval points of the seven Fig.-2 schemes."""
    reference, protocols = curves.TASKS["cifar_conv"]
    design = json.loads((reference / "sca_design.json").read_text())
    assert int(design["d"]) == 268_650 and len(design["gamma"]) == 10
    for protocol in protocols:
        hists = curves.load_reference(protocol, range(8), reference)
        for h in hists:
            assert tuple(h) == tuple(fig2.SCHEMES)
            for rows in h.values():
                assert [r["round"] for r in rows] == list(range(0, 150, 10)) \
                    + [149]
        assert all(r["ok"] for r in curves.gate(hists, hists))
