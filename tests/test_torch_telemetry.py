"""The port's run telemetry (``repro_torch.telemetry``) against the
reference's (``repro.telemetry``, run in a child process with the shim).

* ``Tracer``: a round trip, partial trailing lines, resume pruning, a
  missing log, thread-local context tags.
* ``make_metrics_hook``: the ``bv_*`` traces of the cifar fleet on the
  reference's replayed draws against the reference's at rtol 1e-5 /
  atol 1e-7 (float32 reductions over N = 10 devices in another order; the
  ideal scheme's bias power is zero up to that rounding, hence the atol),
  and the all-truncated-round convention.
* Telemetry off: no ``bv_`` key, no file, and params, the other traces
  and the evals bitwise those of the same run with telemetry on.
* The event kinds with their ``chunk`` and ``tick`` tags, in the
  reference's order, for the cifar fleet with a checkpoint, for its kill
  and resume, and for a population run with ``adaptive_sca`` (stream
  off); walls, ``dur``, run ids and ``cache_size`` are left out, and so
  is the reference's ``chunk_compile`` (the port runs eagerly: no
  compile, no event).
* ``python -m repro_torch.telemetry.report`` on the run dirs the reference
  wrote prints byte for byte what ``repro.telemetry.report`` prints.
* The solver's trace hook fires on the redesign paths only.
"""
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_ref
from repro_torch import fig2, tasks
from repro_torch import telemetry as tlm
from repro_torch.core import channel, power_control as tpc
from repro_torch.core import scenarios as scn
from repro_torch.core.theory import OTAParams
from repro_torch.fl import driver as tdriver
from repro_torch.fl.draws import ReplayDraws
from repro_torch.models.param import params_from_jax
from repro_torch.solvers import sca as tsca
from repro_torch.solvers import theory as tth
from repro_torch.telemetry import report as treport

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
ROUNDS, EVERY, BATCH, SEEDS = 4, 2, 8, (0, 1)
BV_TOL = dict(rtol=1e-5, atol=1e-7)
# what the event comparison leaves out: clocks, durations, the run id, the
# compile cache, and the solver's numbers (the port's f64 torch solver
# lands ~1e-8 from the reference's, tests/test_torch_solvers.py)
VOLATILE = ("wall", "mono", "dur", "run", "cache_size", "wall_s",
            "wall_stage", "objective_mean")


# --- Tracer ------------------------------------------------------------------

def test_tracer_round_trip_and_context(tmp_path):
    tr = tlm.Tracer(str(tmp_path))
    tr.event("a", x=np.int64(3), arr=np.arange(3))
    with tr.ctx(chunk=2):
        with tr.span("s", t=5):
            pass
        done = []
        th = threading.Thread(target=lambda: (tr.event("worker"),
                                              done.append(1)))
        th.start(), th.join()
    evs = tlm.read_events(str(tmp_path))
    assert [e["ev"] for e in evs] == ["run_start", "a", "s", "worker"]
    assert len({e["run"] for e in evs}) == 1
    assert evs[1]["x"] == 3 and evs[1]["arr"] == [0, 1, 2]
    assert evs[2]["chunk"] == 2 and evs[2]["t"] == 5 and evs[2]["dur"] >= 0
    assert "chunk" not in evs[3]          # the context is thread-local
    assert all("wall" in e and "mono" in e for e in evs)


def test_tracer_skips_partial_lines_and_resumes(tmp_path):
    tr = tlm.Tracer(str(tmp_path))
    for ci in range(3):
        tr.event("chunk_exec", chunk=ci)
    tr.event("untagged")
    with open(tr.path, "a") as f:
        f.write('{"ev": "chunk_exec", "chunk": 3')      # killed mid-write
    assert [e.get("chunk") for e in tlm.read_events(tr.path)] \
        == [None, 0, 1, 2, None]
    again = tlm.Tracer(str(tmp_path), fresh=False)
    assert again.run_id == tr.run_id
    again.resume(2)
    evs = tlm.read_events(str(tmp_path))
    assert [(e["ev"], e.get("chunk")) for e in evs] == [
        ("run_start", None), ("chunk_exec", 0), ("chunk_exec", 1),
        ("run_resume", None)]
    assert evs[-1]["start_chunk"] == 2
    assert len({e["run"] for e in evs}) == 1


def test_tracer_missing_log_starts_fresh(tmp_path):
    tr = tlm.Tracer(str(tmp_path / "new"), fresh=False)
    evs = tlm.read_events(str(tmp_path / "new"))
    assert [e["ev"] for e in evs] == ["run_start"]
    assert evs[0]["run"] == tr.run_id
    fresh = tlm.Tracer(str(tmp_path / "new"))
    assert fresh.run_id != tr.run_id
    assert [e["ev"] for e in tlm.read_events(fresh.path)] == ["run_start"]


def test_chunk_cache_audit():
    """The port's chunks are eager: no compile cache to read or audit; an
    object that exposes one is audited as the reference audits it."""
    assert tlm.chunk_cache_size(lambda: None) is None
    with pytest.raises(ValueError, match="no compile cache"):
        with tlm.assert_no_recompile(lambda: None):
            pass

    class Chunk:
        size = 1

        def _cache_size(self):
            return self.size
    c = Chunk()
    with tlm.assert_no_recompile(c, allowed=1):
        c.size = 2
    with pytest.raises(AssertionError, match="recompiled"):
        with tlm.assert_no_recompile(c):
            c.size = 3


# --- the metrics hook --------------------------------------------------------

def test_metrics_hook_conventions():
    hook = tlm.make_metrics_hook(kappa_sq=4.0)
    gen = torch.Generator().manual_seed(0)
    s = torch.rand((3, 5), generator=gen)
    s[1] = 0.0                                  # an all-truncated round
    s[2] = 0.2                                  # uniform
    h = torch.randn((3, 5), generator=gen, dtype=torch.complex64)
    ns = torch.tensor([0.5, 0.0, 2.0])
    params = {"a": torch.zeros(3, 4, 2), "b": torch.zeros(3, 7)}
    out = hook(s=s, noise_scale=ns, h=h, params=params)
    assert sorted(out) == ["bv_bias_power", "bv_chan_power", "bv_noise_var",
                           "bv_weight_dev"]
    assert all(v.shape == (3,) and v.dtype == torch.float32
               for v in out.values())
    assert float(out["bv_bias_power"][1]) == 0.0       # s == 0 -> uniform
    assert abs(float(out["bv_bias_power"][2])) < 1e-12
    pm = (s[0] / s[0].sum()).double()[None]
    want = tth.bias_term(pm, type("K", (), {"kappa_sq": 4.0}))
    assert float(out["bv_bias_power"][0]) == pytest.approx(float(want[0]),
                                                           rel=1e-6)
    assert torch.equal(out["bv_noise_var"], 15 * ns ** 2)
    assert torch.allclose(out["bv_chan_power"],
                          (h.abs() ** 2).mean(-1))
    assert tlm.is_diagnostic("bv_noise_var")
    assert not tlm.is_diagnostic("noise_scale")


# --- against the reference ---------------------------------------------------

@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's arrays, events and report texts; ``dir`` is where
    its run dirs are."""
    out_dir = tmp_path_factory.mktemp("telemetry")
    out = torch_ref.run_reference_telemetry(out_dir, rounds=ROUNDS,
                                            every=EVERY, batch=BATCH,
                                            seeds=SEEDS)
    out["dir"] = out_dir
    return out


def _cifar(ref, **kw):
    task = tasks.get("cifar_conv", **torch_ref.CIFAR_SMOKE_KW)
    schemes = [tpc.scheme_from_jax(n, torch_ref.prefixed(ref, f"scheme/{n}"))
               for n in torch_ref.TEL_SCHEMES]
    draws = ReplayDraws(ref["draws/h"], ref["draws/z"], ref["draws/idx"],
                        ref["draws/coin"], CPU)
    run = task.run_config(num_rounds=ROUNDS, eval_every=EVERY, seed=0,
                          batch_size=BATCH)
    params0 = params_from_jax(torch_ref.prefixed(ref, "params0"))
    return tdriver.run_fleet_task(task, schemes, ref["gains"], run,
                                  params=params0, seeds=SEEDS, flat=True,
                                  draws=draws, device="cpu", **kw)


def _kinds(events):
    """(ev, chunk, tick) of each event, the reference's chunk_compile left
    out."""
    return [(e["ev"], e.get("chunk"), e.get("tick")) for e in events
            if e["ev"] != "chunk_compile"]


def _stable(events):
    """Every event's fields but the volatile ones, chunk_compile left
    out."""
    return [{k: v for k, v in e.items() if k not in VOLATILE}
            for e in events if e["ev"] != "chunk_compile"]


@pytest.fixture(scope="module")
def cifar_runs(ref, tmp_path_factory):
    """The port's cifar fleet with telemetry on (a checkpoint in its run
    dir) and off, and a kill-and-resume pair under telemetry."""
    base = tmp_path_factory.mktemp("port")
    on_dir = base / "cifar"
    tel = tlm.Telemetry(run_dir=str(on_dir), kappa_sq=4.0)
    on = _cifar(ref, telemetry=tel, checkpoint_path=str(on_dir / "fleet"))
    off_dir = base / "off"
    off_dir.mkdir()
    cwd = os.getcwd()
    os.chdir(off_dir)
    try:
        off = _cifar(ref)
    finally:
        os.chdir(cwd)
    res_dir = base / "resume"
    tel = tlm.Telemetry(run_dir=str(res_dir), kappa_sq=4.0)
    first = _cifar(ref, telemetry=tel,
                   checkpoint_path=str(res_dir / "fleet"), max_chunks=1)
    rest = _cifar(ref, telemetry=tel,
                  checkpoint_path=str(res_dir / "fleet"), resume=True)
    return {"on": on, "off": off, "off_dir": off_dir, "on_dir": on_dir,
            "first": first, "rest": rest, "res_dir": res_dir}


def test_bias_variance_traces_match_reference(ref, cifar_runs):
    on = cifar_runs["on"]
    want = {k: v for k, v in torch_ref.prefixed(ref, "cifar/traces").items()
            if k.startswith("bv_")}
    assert sorted(want) == ["bv_bias_power", "bv_chan_power",
                            "bv_noise_var", "bv_weight_dev"]
    for k, v in want.items():
        assert on.traces[k].shape == v.shape == (2, 2, ROUNDS)
        assert on.traces[k].dtype == np.float32
        np.testing.assert_allclose(on.traces[k], v, **BV_TOL, err_msg=k)


def test_telemetry_off_is_bitwise_and_writes_nothing(cifar_runs):
    on, off = cifar_runs["on"], cifar_runs["off"]
    assert not any(tlm.is_diagnostic(k) for k in off.traces)
    assert sorted(off.traces) == ["active_devices", "grad_norm_mean",
                                  "noise_scale"]
    assert list(cifar_runs["off_dir"].iterdir()) == []
    for k in off.params:
        assert torch.equal(on.params[k], off.params[k]), k
    for k in off.traces:
        assert np.array_equal(on.traces[k], off.traces[k]), k
    assert [t for t, _ in on.evals] == [t for t, _ in off.evals]
    for (_, a), (_, b) in zip(on.evals, off.evals):
        for k in a:
            assert np.array_equal(a[k], b[k]), k


def test_cifar_events_match_reference(ref, cifar_runs):
    got = tlm.read_events(str(cifar_runs["on_dir"]))
    want = json.loads(str(ref["cifar/events"]))
    assert _kinds(got) == _kinds(want)
    assert _stable(got) == _stable(want)
    execs = [e for e in got if e["ev"] == "chunk_exec"]
    assert [e["chunk"] for e in execs] == list(range(len(execs)))
    assert all(e["cache_size"] is None for e in execs)


def test_kill_and_resume_keeps_one_log(ref, cifar_runs):
    first, rest = cifar_runs["first"], cifar_runs["rest"]
    on = cifar_runs["on"]
    for k in on.params:
        assert torch.equal(on.params[k], rest.params[k]), k
    for k in on.traces:
        assert np.array_equal(on.traces[k], rest.traces[k]), k
    got = tlm.read_events(str(cifar_runs["res_dir"]))
    assert len({e["run"] for e in got}) == 1
    execs = [e["chunk"] for e in got if e["ev"] == "chunk_exec"]
    assert execs == sorted(set(execs)) == list(range(len(execs)))
    assert sum(e["ev"] == "run_resume" for e in got) == 1
    want = json.loads(str(ref["resume/events"]))
    assert _kinds(got) == _kinds(want)
    assert _stable(got) == _stable(want)
    assert sum(n for n, _ in first.chunk_walls) < ROUNDS


@pytest.fixture(scope="module")
def population_events(ref, tmp_path_factory):
    """The port's population run with adaptive_sca under telemetry, in the
    reference's world (stream off), and the same with stream on."""
    mlp = tasks.get("paper_mlp", hidden=16, samples_per_class=40)
    p = torch_ref.TEL_POP
    w = channel.WirelessConfig(num_devices=p["cohort"], seed=0)
    dep = channel.deploy(w)
    prm = OTAParams(d=mlp.param_dim, gmax=10.0, es=w.energy_per_sample,
                    n0=w.noise_psd, gains=dep.gains,
                    sigma_sq=np.zeros(p["cohort"]), eta=0.05, lsmooth=1.0,
                    kappa_sq=4.0)
    pcs = [tpc.make_adaptive_sca(dep, prm, base=tpc.make_sca(
        dep, prm, method="scipy"))]
    pop = scn.Population(spec=scn.PopulationSpec(
        size=p["size"], shadowing=scn.ShadowingSpec(), sampling="traffic",
        dynamics=scn.DynamicsSpec(rho=p["rho"]), seed=p["pop_seed"]))
    run = mlp.run_config(eta=0.05, num_rounds=p["pop_rounds"],
                         eval_every=p["pop_every"], seed=0, batch_size=BATCH)
    out = {}
    for label, stream in (("serial", False), ("stream", True)):
        run_dir = tmp_path_factory.mktemp(label)
        tdriver.run_fleet_task(
            mlp, pcs, dep.gains, run, seeds=SEEDS, flat=True,
            population=pop, cohort_size=p["cohort"],
            cohort_rounds=p["cohort_rounds"], stream=stream,
            telemetry=tlm.Telemetry(run_dir=str(run_dir), kappa_sq=4.0),
            checkpoint_path=str(run_dir / "fleet"), device="cpu")
        out[label] = tlm.read_events(str(run_dir))
    return out


def test_population_events_match_reference(ref, population_events):
    """Every stable field too: the cohorts' staleness, the stages'
    ``redesigned``, the solves' batch (one cohort solve serves the K
    schemes in the port; here K = 1, so the rows are the reference's)."""
    got = population_events["serial"]
    want = json.loads(str(ref["population/events"]))
    assert _kinds(got) == _kinds(want)
    assert _stable(got) == _stable(want)


def test_population_events_stream_tags(population_events):
    """Stream on: every event of the serial run, the staging thread's
    ``sca_solve`` and ``stage`` tagged with the chunk they stage, a
    ``stage_wait`` for every chunk after the first, cohorts with the
    staleness of each drawn device."""
    got, serial = population_events["stream"], population_events["serial"]
    assert sorted(map(str, _kinds([e for e in got
                                   if e["ev"] != "stage_wait"]))) \
        == sorted(map(str, _kinds(serial)))
    solves = [e for e in got if e["ev"] == "sca_solve"]
    stages = [e for e in got if e["ev"] == "stage"]
    assert solves and all(isinstance(e.get("chunk"), int) for e in solves)
    assert {e["chunk"] for e in solves} \
        == {e["chunk"] for e in stages if e["redesigned"]}
    waits = [e["chunk"] for e in got if e["ev"] == "stage_wait"]
    assert waits == sorted(e["chunk"] for e in stages)[1:]
    cohorts = [e for e in got if e["ev"] == "cohort"]
    assert cohorts and all(np.asarray(e["staleness"]).shape
                           == (len(SEEDS), torch_ref.TEL_POP["cohort"])
                           for e in cohorts)


@pytest.mark.parametrize("tag", ["cifar", "resume", "population"])
def test_report_matches_reference_byte_for_byte(ref, tag, tmp_path):
    run_dir = ref["dir"] / tag
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.telemetry.report", str(run_dir)],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout == str(ref[f"{tag}/report"])


def test_report_on_port_run_prints_every_section(cifar_runs, capsys):
    treport.main([str(cifar_runs["on_dir"])])
    text = capsys.readouterr().out
    for title in ("== run ", "== staging-lane timeline", "== SCA solver",
                  "== bias--variance trajectory", "== cohort staleness",
                  "== recompilation audit"):
        assert title in text, title
    assert "bv_bias_power" in text and "(no compiles recorded)" in text
    with pytest.raises(SystemExit, match="no events.jsonl"):
        treport.main([str(cifar_runs["off_dir"])])


# --- the solver's hook, the driver's and fig2's refusals ---------------------

def test_trace_hook_fires_on_redesign_paths_only(monkeypatch):
    """The hook's wiring, with the solve itself stubbed (the solver is held
    against the reference in tests/test_torch_solvers.py): the initial
    designs (``make_sca_batch``, ``solve_batch``) fire nothing; the cohort
    redesign (``solve_batch_traced``) fires once per batched solve."""
    def fake_solve(prms, cfg=tsca.DEFAULT_CONFIG, device=None):
        b, n = prms.gains.shape if hasattr(prms, "gains") \
            else (len(prms), prms[0].num_devices)
        return tsca.BatchResult(
            gamma=np.full((b, n), 1e-10), p=np.full((b, n), 0.5),
            alpha=np.full(b, 1e-9), objective=np.arange(b, dtype=float),
            history=np.zeros((b, cfg.max_iters + 2)),
            converged=np.array([True] + [False] * (b - 1)))
    monkeypatch.setattr(tsca, "solve_batch", fake_solve)
    monkeypatch.setattr("repro_torch.solvers.solve_batch", fake_solve)
    dep = channel.deploy(channel.WirelessConfig(num_devices=6, seed=0))
    prm = OTAParams(d=1000, gmax=10.0, es=1.0, n0=1e-20, gains=dep.gains,
                    sigma_sq=np.zeros(6), eta=0.05, lsmooth=1.0,
                    kappa_sq=4.0)
    recs = []
    prev = tsca.set_trace_hook(recs.append)
    try:
        base = tpc.make_sca_batch([prm], device="cpu")[0]
        pc = tpc.make_adaptive_sca(dep, prm, base=base)
        assert recs == []                     # initial designs: no event
        pc.redesign_cohort_fn(pc, np.stack([dep.gains, dep.gains[::-1]]))
    finally:
        assert tsca.set_trace_hook(prev) == recs.append
    assert len(recs) == 1
    rec = recs[0]
    assert sorted(rec) == ["batch", "converged", "dur", "iters",
                           "objective_mean"]
    assert (rec["batch"], rec["converged"], rec["objective_mean"],
            rec["iters"]) == (2, 1, 0.5, tsca.DEFAULT_CONFIG.max_iters)
    pc.redesign_cohort_fn(pc, dep.gains[None])
    assert len(recs) == 1                     # the hook was restored


def test_run_fleet_telemetry_accepted_placement_refused(tmp_path):
    task = tasks.get("paper_mlp", hidden=16, samples_per_class=10)
    td = task.build_data(0)
    run = task.run_config(num_rounds=2, eval_every=2, batch_size=4)
    pcs = [tpc.Ideal(name="ideal")]
    res = tdriver.run_fleet_task(task, pcs, np.full(10, 1e-12), run,
                                 task_data=td, device="cpu",
                                 telemetry=str(tmp_path / "run"))
    assert "bv_noise_var" in res.traces
    kinds = [e["ev"] for e in tlm.read_events(str(tmp_path / "run"))]
    assert kinds[:2] == ["run_start", "fleet_config"] \
        and kinds[-1] == "run_end"
    with pytest.raises(NotImplementedError, match="module 12"):
        tdriver.run_fleet_task(task, pcs, np.full(10, 1e-12), run,
                               task_data=td, device="cpu", placement="mesh")


@pytest.mark.parametrize("flag", ["--legacy", "--bench"])
def test_fig2_telemetry_refusals(flag):
    with pytest.raises(SystemExit, match="--telemetry"):
        fig2.main(["--task", "cifar_conv", "--telemetry", flag,
                   "--device", "cpu"])
