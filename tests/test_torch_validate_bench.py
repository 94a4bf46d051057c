"""The port's ``validate_bench`` against the reference's
(``benchmarks/validate_bench.py``, numpy and json only, run in process):
the same verdicts, error for error, on the committed ``BENCH_engine.json``
and on broken copies of it; and ``fig2 --bench --json``'s summaries, which
it checks before they are written."""
import copy
import json
from pathlib import Path

import pytest

from benchmarks import validate_bench as jvb
from repro_torch import fig2
from repro_torch import validate_bench as tvb

ROOT = Path(__file__).resolve().parents[1]
COMMITTED = json.loads((ROOT / "BENCH_engine.json").read_text())


def _break(path, value=None, delete=False):
    """A copy of the committed summary with one key replaced or removed."""
    out = copy.deepcopy(COMMITTED)
    node = out
    for key in path[:-1]:
        node = node[key]
    if delete:
        del node[path[-1]]
    else:
        node[path[-1]] = value
    return out


BROKEN = {
    "committed": COMMITTED,
    "no_source": _break(["source"], delete=True),
    "extra_key": _break(["nonsense"], 1),
    "negative_wall": _break(["wall_s", "fleet_fullbatch"], -1.0),
    "string_speedup": _break(["speedup", "engine_vs_legacy"], "fast"),
    "stage_chunks_off": _break(["population", "stage_chunks_s"],
                               {"stream": [1.0, 2.0], "serial": [0.5]}),
    "zero_rounds_per_sec": _break(["population", "rounds_per_sec"], 0),
    "c1_not_bitwise": _break(["scenario_grid", "c1_slice_bitwise"], False),
    "round_step_missing_dtype": _break(
        ["round_step"], {"kernel": [{"uplink_dtype": "f32"}],
                         "fleet": {"f32": {}, "bf16": {}}}),
    "no_placement_rows": _break(["placement", "rows"], []),
}


@pytest.mark.parametrize("case", sorted(BROKEN))
def test_verdicts_match_reference(case, tmp_path):
    path = tmp_path / "bench.json"
    path.write_text(json.dumps(BROKEN[case]))
    got = tvb.validate(str(path))
    assert got == jvb.validate(str(path))
    assert bool(got) == (case != "committed")
    assert got == tvb.validate_summary(BROKEN[case])


def test_schema_is_the_reference_copy():
    ours = json.loads(Path(tvb.SCHEMA).read_text())
    theirs = json.loads((ROOT / "benchmarks" / "bench_schema.json")
                        .read_text())
    assert ours["properties"] == theirs["properties"]
    assert ours["required"] == theirs["required"]


ENGINE_REPORT = {
    "grid": {"task": "paper_mlp", "schemes": list(fig2.SCHEMES),
             "num_rounds": 150, "eval_every": 15, "seed": 0,
             "bench_batch_size": 128, "device": "cpu",
             "backend": "torch-cpu"},
    "wall_s": {"legacy_loop_fullbatch": 20.0, "fleet_fullbatch": 2.0,
               "fleet_fullbatch_compile": 0.5, "fleet_fullbatch_exec": 1.5,
               "fleet_minibatch": 2.5, "fleet_minibatch_compile": 0.6,
               "fleet_minibatch_exec": 1.9},
    "speedup": {"engine_vs_legacy": 8.0, "fullbatch_engine_vs_legacy": 10.0,
                "engine_exec_vs_legacy": 10.5},
    "equivalence": {"note": "", "max_abs_delta": {"acc": 0.0,
                                                  "global_loss": 1e-6}},
    "final_acc": {},
}
POP_REPORT = {
    "config": {"task": "paper_mlp", "population": 1000000, "cohort": 50,
               "num_rounds": 48, "eval_every": 16, "cohort_rounds": 1,
               "seed": 0, "batch_size": 128, "scheme": "adaptive_sca",
               "sampling": "traffic", "device": "cpu",
               "backend": "torch-cpu"},
    "wall_s": {"stream_exec": 9.0, "serial_exec": 9.5, "stream_stage": 3.0,
               "serial_stage": 3.25},
    "stage_chunks_s": {"stream": [1.0, 2.0], "serial": [1.25, 2.0]},
    "round_ms": {"stream": 5.0, "serial": 5.1},
    "rounds_per_sec": 5.2, "overlap_saving_s": 0.5,
    "stream_bitwise": True, "full_cohort_bitwise": True,
    "launches": {"stream": {"ota_round_step": 48}},
    "result": object(),
}


@pytest.mark.parametrize("report", [ENGINE_REPORT, POP_REPORT],
                         ids=["engine", "population"])
def test_bench_json_is_schema_checked(report, tmp_path):
    path = tmp_path / "out" / "bench.json"
    fig2.write_bench(report, "paper_mlp", str(path))
    summary = json.loads(path.read_text())
    assert summary["task"] == "paper_mlp" and summary["source"]
    assert tvb.validate(str(path)) == jvb.validate(str(path)) == []
    full = json.loads((path.parent / "bench.report.json").read_text())
    assert "result" not in full and set(full) == set(report) - {"result"}
    bad = copy.deepcopy({k: v for k, v in report.items() if k != "result"})
    bad["wall_s"] = {k: -1.0 for k in bad["wall_s"]}
    with pytest.raises(ValueError, match="bench schema"):
        fig2.write_bench(bad, "paper_mlp", str(tmp_path / "bad.json"))
    assert not (tmp_path / "bad.json").exists()
