"""The port's scripts (module 14) against the reference's, on the CPU.

``repro_torch.run`` (the harness: ``_csv``, ``smoke``), the new parts of
``repro_torch.fig2`` (``rounds_to_accuracy``, ``summarize``,
``kernel_benchmark``, ``--bench-kernel``), ``sca_bench.solver_rows``,
``repro_torch.kernel_bench`` and ``kernels.ref.ssd_ref``, and
``scenario_sweep.train_sweep``'s keywords.  The reference's functions run
in a child process (``torch_ref.run_reference_scripts``) on inputs both
sides rebuild from numpy seeds; ``benchmarks.run._csv`` imports no JAX and
runs here.  On the CPU every kernel call takes its plain version, so the
card's rows and the fused-vs-unfused pin on K1 and K2 are in
``test_torch_kernels_cuda.py``.

The smoke runs at a cut paper_mlp (hidden 16, 20 samples a class) with
designs handed in: the SLSQP oracle's ``sca`` designs (the torch solver
takes ~9 s a solve on this CPU); the solver gate's batched solve is the
torch solver's own, and the adaptive fleet's two redesigns solve here.
"""
import ast
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import fig2, kernel_bench, run, sca_bench, scenario_sweep
from repro_torch import tasks, validate_bench
from repro_torch.core import power_control as pcm
from repro_torch.kernels import ops, ref
import torch_ref

ROOT = Path(__file__).resolve().parents[1]
SEQ_TOL = dict(rtol=2e-4, atol=2e-4)      # tests/test_torch_ssm.py's
CUT = dict(hidden=16, samples_per_class=20)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run many tiny ops, which threads
    only slow down, and the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return torch_ref.run_reference_scripts(
        tmp_path_factory.mktemp("ref") / "scripts.npz")


@pytest.mark.parametrize("row", [
    {"bench": "smoke_fig2_sca", "final_acc": 0.1234},
    {"scheme": "sca", "final_acc": 0.9, "rounds_to_80": None},
    {"arch": "qwen", "shape": "decode_32k", "us_per_call": 12.5, "x": 1},
    {"us_per_call": 3.0},
    {"bench": "sca_solver_n10_b1", "us_per_call": 1.5, "gap_max": "1e-07"}])
def test_csv_matches_reference(row):
    from benchmarks.run import _csv as ref_csv
    assert run._csv(dict(row)) == ref_csv(dict(row))


def test_summarize_and_rounds_to_accuracy_match_reference(reference):
    hist = torch_ref.script_histories()
    want = reference["blob"]
    assert fig2.summarize(hist) == want["summarize"]
    for name, h in hist.items():
        for t in torch_ref.SCRIPT_TARGETS:
            assert fig2.rounds_to_accuracy(h, t) \
                == want["rounds_to"][f"{name}/{t}"]
    assert any(v is None for v in want["rounds_to"].values())


def test_solver_rows_match_reference(reference):
    got = sca_bench.solver_rows(torch_ref.script_solver_result("torch"))
    assert got == reference["blob"]["solver_rows"]
    assert [run._csv(dict(r)) for r in got] \
        == [run._csv(dict(r)) for r in reference["blob"]["solver_rows"]]


@pytest.mark.parametrize("case", range(len(torch_ref.SSD_SHAPES)))
def test_ssd_ref_matches_reference(reference, case):
    args = torch_ref.ssd_inputs(*torch_ref.SSD_SHAPES[case], seed=case)
    y = ref.ssd_ref(*map(torch.from_numpy, args))
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), reference[f"ssd/{case}"],
                               **SEQ_TOL)


@pytest.mark.parametrize("case", range(len(torch_ref.SSD_SHAPES)))
@pytest.mark.parametrize("chunk", [16, 32])
def test_ssd_chunked_matches_ssd_ref(case, chunk):
    t = [torch.from_numpy(a) for a in
         torch_ref.ssd_inputs(*torch_ref.SSD_SHAPES[case], seed=case)]
    y, _ = ref.ssd_chunked(*t, chunk)
    np.testing.assert_allclose(y.numpy(), ref.ssd_ref(*t).numpy(), **SEQ_TOL)


def _reference_round_step_columns() -> list:
    """The keys of the row ``benchmarks/kernel_bench.py::round_step_rows``
    appends, in order, read from its source."""
    src = (ROOT / "benchmarks" / "kernel_bench.py").read_text()
    block = re.search(r'rows\.append\(\{("uplink_dtype".*?)\}\)', src,
                      re.S).group(1)
    return re.findall(r'"(\w+)":', block)


def test_round_step_rows_match_reference_columns():
    rows = kernel_bench.round_step_rows(n=4, d=65_536, iters=2,
                                        device="cpu")
    assert [r["uplink_dtype"] for r in rows] == list(kernel_bench.UPLINKS)
    for r in rows:
        assert list(r) == _reference_round_step_columns()
        assert r["fused_us"] > 0 and r["unfused_us"] > 0
    f32 = next(r for r in rows if r["uplink_dtype"] == "f32")
    assert f32["max_err_vs_f32"] == 0.0
    # the reference's bytes: wire in, z and params in, params out (f32);
    # unfused adds ghat's write and read
    assert f32["uplink_mb"] == round(4 * 65_536 * 4 / 1e6, 2)
    assert f32["fused_bytes_mb"] == round((4 * 65_536 * 4 + 3 * 65_536 * 4)
                                          / 1e6, 2)


@pytest.mark.parametrize("uplink", kernel_bench.UPLINKS)
def test_fused_equals_unfused_on_the_plain_versions(uplink):
    gen = torch.Generator().manual_seed(3)
    n, d = 4, 65_536
    g = torch.randn((1, n, d), generator=gen)
    s = 0.1 + 0.9 * torch.rand((1, n), generator=gen)
    z, p = torch.randn((1, d), generator=gen), torch.randn((1, d),
                                                           generator=gen)
    ns, eta = torch.full((1,), 0.2), torch.full((1,), 0.05)
    wire, qs = ops.quantize_uplink(g, uplink)
    fused = ops.ota_round_step_flat(wire, s, z, ns, p, eta, qs)
    ghat = ops.ota_aggregate_flat(ops.dequantize_uplink(wire, qs), s, z, ns)
    assert torch.equal(fused, p - eta[:, None] * ghat)


def test_round_step_equivalence_on_cpu():
    before = ref.ota_round_step_ref.calls
    assert kernel_bench.round_step_equivalence(device="cpu") == 0.0
    assert ref.ota_round_step_ref.calls == before + 6


def test_kernel_bench_rows_hold_on_cpu(monkeypatch):
    src = (ROOT / "benchmarks" / "kernel_bench.py").read_text()
    names = re.findall(r'"bench": "([a-z0-9_]+)"', src)
    # the rows' shapes cut (the card runs the reference's)
    monkeypatch.setattr(kernel_bench, "OTA", (10, 5000))
    monkeypatch.setattr(kernel_bench, "ATTN",
                        ("cut", 1, 256, 8, 2, 64, "f32"))
    monkeypatch.setattr(kernel_bench, "SSD", (1, 200, 8, 64, 1, 64))
    rows = kernel_bench.run("cpu", iters=1)
    assert [r["bench"] for r in rows] == names
    agg, attn, ssd = rows
    assert agg["bitwise"] and agg["kernel_max_err"] == 0.0
    assert attn["max_err"] == 0.0
    assert ssd["max_err"] <= 1e-3 and ssd["speedup_vs_sequential"] > 0
    assert all(r["bound_us"] > 0 for r in rows)


def _scipy_schemes(task, dep, prm, names):
    """``fig2.make_schemes`` with the SLSQP oracle's ``sca``."""
    return [pcm.make_power_control(
        n, dep, prm.replace(eta=task.eta_for(n, float(prm.eta))),
        **({"method": "scipy"} if n == "sca" else {})) for n in names]


@pytest.fixture(scope="module")
def cut_world():
    task = tasks.get("paper_mlp", expect_runtime="fleet", **CUT)
    dep, prm, td = fig2.build_world(task, 0)
    return task, dep, prm, _scipy_schemes(task, dep, prm, fig2.SCHEMES)


def test_kernel_benchmark_bitwise_and_schema(cut_world, monkeypatch):
    task, _, _, pcs = cut_world
    # the micro rows cut (the card runs them at the paper's scale)
    rows = kernel_bench.round_step_rows
    monkeypatch.setattr(kernel_bench, "round_step_rows",
                        lambda **kw: rows(n=4, d=4096, **kw))
    rep = fig2.kernel_benchmark(task, num_rounds=3, eval_every=3,
                                designs=pcs, device="cpu", log=False)
    assert rep["f32_bitwise"] and rep["interpret_max_err"] == 0.0
    for ud in kernel_bench.UPLINKS:
        f = rep["fleet"][ud]
        assert f["bitwise_fused_vs_unfused"], ud
        # CPU tensors: the plain versions, once a round each
        assert f["launches"]["fused"] == {
            "ota_round_step": 0, "ota_aggregate": 0, "plain_round_step": 3,
            "plain_aggregate": 0}
        assert f["launches"]["unfused"] == {
            "ota_round_step": 0, "ota_aggregate": 0, "plain_round_step": 0,
            "plain_aggregate": 3}
    summary = fig2.bench_summary({"round_step": rep}, task.name,
                                 "repro_torch.fig2 --bench-kernel")
    assert set(summary) == {"source", "task", "round_step"}
    assert validate_bench.validate_summary(summary) == []
    broken = dict(rep, fleet={k: v for k, v in rep["fleet"].items()
                              if k != "int8"})
    assert validate_bench.validate_summary(
        fig2.bench_summary({"round_step": broken}, task.name, "x"))


@pytest.mark.parametrize("argv", [
    ["--bench-kernel", "--checkpoint"], ["--bench-kernel", "--resume"],
    ["--bench-kernel", "--telemetry"]])
def test_bench_kernel_refuses_what_the_reference_refuses(argv):
    with pytest.raises(SystemExit) as e:
        fig2.main(argv + ["--device", "cpu"])
    assert "--bench-kernel" in str(e.value)


@pytest.fixture(scope="module")
def scn_world(cut_world):
    """The smoke scenarios' world at the cut task's d, ``sca`` from the
    SLSQP oracle."""
    task = cut_world[0]
    world = scenario_sweep.design(run.SMOKE_SCENARIOS, schemes=("lcpc",
                                                                "zero_bias"),
                                  d=task.param_dim, device="cpu")
    for name in run.SMOKE_SCENARIOS:
        w = world[name]
        w["schemes"] = [pcm.make_sca(w["dep"], w["prm"], method="scipy")] \
            + w["schemes"]
    return world


def test_train_sweep_keywords_are_the_defaults_bitwise(cut_world, scn_world):
    task = cut_world[0]
    names = run.SMOKE_SCENARIOS[:1]
    world = dict(scn_world, order=names)
    at_defaults = scenario_sweep.train_sweep(world, task, "cpu")
    given = scenario_sweep.train_sweep(
        world, task, "cpu", scenario_names=names,
        num_rounds=scenario_sweep.ROUNDS, eval_every=scenario_sweep.EVERY,
        seed=0, batch_size=None)
    # the function as it was: ROUNDS rounds, seed 0, the task's batch
    td = task.build_data(0)
    res = scenario_sweep.scenario_fleet(
        task, world, names[0],
        scenario_sweep.run_config(task, scenario_sweep.ROUNDS,
                                  scenario_sweep.EVERY), (0,),
        task_data=td, params=task.init_params(0, "cpu"),
        eval_fn=task.make_eval(td, "cpu"), device="cpu")
    was = [{"scenario": names[0], "scheme": s,
            "final_acc": round(float(res.evals[-1][1]["acc"][i, 0]), 4),
            "rounds": scenario_sweep.ROUNDS}
           for i, s in enumerate(res.names)]
    assert at_defaults == given == was
    assert [r["scheme"] for r in was] == list(scenario_sweep.SCHEMES)


def _reference_smoke_names() -> list:
    """The reference smoke's row names on one device, read from
    ``benchmarks/run.py`` (the templates) and the scheme lists of
    ``benchmarks/fig2.py`` and ``benchmarks/scenario_sweep.py``."""
    def literal(path, name):
        for node in ast.parse((ROOT / path).read_text()).body:
            if isinstance(node, ast.Assign) and any(
                    getattr(t, "id", None) == name for t in node.targets):
                return ast.literal_eval(node.value)
        raise KeyError(name)
    src = (ROOT / "benchmarks" / "run.py").read_text()
    templates = re.findall(r'"bench": f?"(smoke_[^"]+)"', src)
    assert templates == ["smoke_fig2_{name}",
                         "smoke_{r['scenario']}_{r['scheme']}",
                         "smoke_solver_batch4", "smoke_adaptive_sca",
                         "smoke_cifar_conv_{where}"]
    scenarios = re.search(r"scenario_names=\(([^)]*)\)", src).group(1)
    scenarios = ast.literal_eval(f"({scenarios})")
    assert 'placement, where = None, "vmap"' in src
    return ([f"smoke_fig2_{n}" for n in literal("benchmarks/fig2.py",
                                                "SCHEMES")]
            + [f"smoke_{sc}_{s}" for sc in scenarios
               for s in literal("benchmarks/scenario_sweep.py", "SCHEMES")]
            + ["smoke_solver_batch4", "smoke_adaptive_sca",
               "smoke_cifar_conv_vmap"])


def _made(label, value_fn):
    prms, what = run._worlds(label, 0)
    return run.Made(prms, value_fn(what), 0.0)


def test_smoke_on_cpu_with_designs_handed_in(cut_world, scn_world, capsys,
                                             monkeypatch):
    task, _, prm, pcs = cut_world
    monkeypatch.setattr(run, "_fig2_task", lambda: task)
    designs = {
        "fig2": run.Made((prm,), pcs, 0.0),
        "scenarios": run.Made(tuple(scn_world[n]["prm"]
                                    for n in run.SMOKE_SCENARIOS),
                              scn_world, 0.0),
        "adaptive": _made("adaptive", lambda w: pcm.make_sca(
            w[1], w[2], method="scipy")),
        "cifar": _made("cifar", lambda w: _scipy_schemes(
            w[0], w[1], w[2], run.CIFAR_SCHEMES))}
    out = run.smoke(0, "cpu", designs=designs)
    printed = capsys.readouterr().out.splitlines()
    assert printed[0] == "bench,us_per_call,derived"
    assert printed[-1] == "# smoke OK"
    names = [line.split(",")[0] for line in out["rows"]]
    assert names == _reference_smoke_names()
    # every design was handed in; the solver gate's batched solve ran here
    assert "designs_s" not in out["walls"] and out["walls"]["solver_s"] > 0
    assert len(out["walls"]["redesign_s"]) == 2
    lc = out["launches"]
    assert lc["fig2"]["plain_round_step"] == 8
    assert lc["scenarios"]["plain_round_step"] == 2 * 4
    assert lc["solver_adaptive"]["plain_round_step"] == 0
    assert lc["cifar"]["plain_round_step"] == 1 + 5 + 6
    assert all(v == 0 for g in lc.values()
               for k, v in g.items() if not k.startswith("plain"))
    row = dict(kv.split("=") for kv in out["rows"][-1].split(",")[2]
               .split(";"))
    assert row["resume_bitwise"] == "1" and row["resumed_rounds_done"] == "1"


def test_smoke_refuses_a_design_of_another_world(cut_world, monkeypatch):
    task, dep, prm, pcs = cut_world
    monkeypatch.setattr(run, "_fig2_task", lambda: task)
    other = prm.replace(eta=0.07)
    with pytest.raises(ValueError, match="another world"):
        run.smoke(0, "cpu", designs={"fig2": run.Made((other,), pcs, 0.0)})


@pytest.mark.parametrize("with_records", (True, False))
def test_run_roofline_section(with_records, capsys, tmp_path):
    """``run.main``'s roofline section, the reference's (``benchmarks/
    run.py``): one row a dry-run record, the reference's keys and
    formats; without records, its line saying how to make them."""
    from repro_torch import configs, roofline
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun
    if with_records:
        rec = dryrun.run_one(
            "qwen1.5-0.5b", InputShape("prefill_32k", 40, 2, "prefill"),
            cfg=configs.get_config("qwen1.5-0.5b").smoke(), save=False)
        (tmp_path / "x_card.json").write_text(json.dumps(rec))
    run.roofline_section(str(tmp_path))
    out = capsys.readouterr().out
    if not with_records:
        assert out == ("# no dryrun artifacts yet — run: PYTHONPATH=src "
                       "python -m repro_torch.launch.dryrun --all\n")
        return
    lines = out.splitlines()
    assert len(lines) == 1
    name, us, derived = lines[0].split(",", 2)
    row = roofline.roofline_row(rec)
    assert name == "roofline_qwen1.5-0.5b_prefill_32k" and us == ""
    kv = dict(x.split("=", 1) for x in derived.split(";"))
    assert list(kv) == ["devices", "compute_s", "memory_s", "collective_s",
                        "collective_note", "dominant",
                        "model_flops_per_device", "useful_flops_ratio",
                        "hbm_gb_per_device"]
    for k in ("compute_s", "memory_s", "collective_s",
              "model_flops_per_device"):
        assert kv[k] == f"{row[k]:.4g}", k
    assert kv["useful_flops_ratio"] == f"{row['useful_flops_ratio']:.3f}"
    assert kv["dominant"] == row["dominant"]
