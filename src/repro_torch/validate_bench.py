"""Validate a benchmark summary against ``bench_schema.json``, ported
from ``benchmarks/validate_bench.py`` (the port keeps its own copy of the
schema, ``src/repro_torch/bench_schema.json``).

    PYTHONPATH=src python -m repro_torch.validate_bench [path]

``repro_torch.fig2 --bench --json`` and ``--bench --population --json``
run it on the summary they write (``fig2.write_bench``); with no path it
checks the repo-root ``BENCH_engine.json``.

Uses ``jsonschema`` when importable; otherwise a minimal built-in checker
covering the subset the schema uses (type, required, properties,
additionalProperties, items, minimum / exclusiveMinimum, minItems).

Beyond the shape, the reference's semantic invariants are checked: the
per-chunk staging breakdown ``population.stage_chunks_s`` (when present)
must sum back to the ``population.wall_s.{stream,serial}_stage``
aggregates; the ``round_step`` section (when present) must carry
fused-vs-unfused walls for every uplink dtype (f32/bf16/int8) in its
kernel rows and its fleet grid; and the ``scenario_grid`` section (when
present) must reconcile its sequential walls with their total and the
speedup, and hold ``c1_slice_bitwise`` true.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.join(os.path.dirname(__file__), "..", "..")
DEFAULT_SUMMARY = os.path.join(ROOT, "BENCH_engine.json")
SCHEMA = os.path.join(os.path.dirname(__file__), "bench_schema.json")

_TYPES = {"object": dict, "array": list, "string": str, "boolean": bool,
          "integer": int, "number": (int, float)}


def _check(obj, schema: dict, path: str, errors: list) -> None:
    """Minimal recursive draft-07 subset checker (fallback path)."""
    typ = schema.get("type")
    if typ is not None:
        pytype = _TYPES[typ]
        ok = isinstance(obj, pytype)
        if typ in ("integer", "number") and isinstance(obj, bool):
            ok = False
        if not ok:
            errors.append(f"{path or '$'}: expected {typ}, "
                          f"got {type(obj).__name__}")
            return
    if isinstance(obj, dict):
        for req in schema.get("required", ()):
            if req not in obj:
                errors.append(f"{path or '$'}: missing required key {req!r}")
        props = schema.get("properties", {})
        extra = schema.get("additionalProperties", True)
        for key, val in obj.items():
            if key in props:
                _check(val, props[key], f"{path}/{key}", errors)
            elif isinstance(extra, dict):
                _check(val, extra, f"{path}/{key}", errors)
            elif extra is False:
                errors.append(f"{path or '$'}: unexpected key {key!r}")
    elif isinstance(obj, list):
        if len(obj) < schema.get("minItems", 0):
            errors.append(f"{path or '$'}: fewer than "
                          f"{schema['minItems']} items")
        items = schema.get("items")
        if items is not None:
            for i, val in enumerate(obj):
                _check(val, items, f"{path}/{i}", errors)
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        if "minimum" in schema and obj < schema["minimum"]:
            errors.append(f"{path or '$'}: {obj} < min {schema['minimum']}")
        if "exclusiveMinimum" in schema \
                and obj <= schema["exclusiveMinimum"]:
            errors.append(f"{path or '$'}: {obj} <= exclusive min "
                          f"{schema['exclusiveMinimum']}")


def _check_stage_chunks(summary: dict, errors: list) -> None:
    """population.stage_chunks_s must reconcile with the wall_s aggregates
    (each chunk wall rounds to 4 decimals, the aggregate to 2)."""
    pop = summary.get("population")
    if not isinstance(pop, dict):
        return
    chunks = pop.get("stage_chunks_s")
    walls = pop.get("wall_s")
    if not isinstance(chunks, dict) or not isinstance(walls, dict):
        return
    for mode in ("stream", "serial"):
        per_chunk = chunks.get(mode)
        total = walls.get(f"{mode}_stage")
        if not isinstance(per_chunk, list) or total is None:
            continue
        tol = 0.01 + 5e-5 * len(per_chunk)       # rounding headroom
        if abs(sum(per_chunk) - total) > tol:
            errors.append(
                f"population/stage_chunks_s/{mode}: chunks sum to "
                f"{sum(per_chunk):.4f}s but wall_s.{mode}_stage is "
                f"{total}s")


_UPLINK_DTYPES = ("f32", "bf16", "int8")


def _check_round_step(summary: dict, errors: list) -> None:
    """round_step (when present) must cover every uplink dtype in both
    the kernel micro rows and the end-to-end fleet walls."""
    rs = summary.get("round_step")
    if not isinstance(rs, dict):
        return
    rows = rs.get("kernel")
    if isinstance(rows, list):
        seen = {r.get("uplink_dtype") for r in rows if isinstance(r, dict)}
        missing = set(_UPLINK_DTYPES) - seen
        if missing:
            errors.append(f"round_step/kernel: missing uplink dtypes "
                          f"{sorted(missing)}")
    fleet = rs.get("fleet")
    if isinstance(fleet, dict):
        missing = set(_UPLINK_DTYPES) - set(fleet)
        if missing:
            errors.append(f"round_step/fleet: missing uplink dtypes "
                          f"{sorted(missing)}")


def _check_scenario_grid(summary: dict, errors: list) -> None:
    """scenario_grid (when present) must reconcile with itself: one
    sequential wall per configured scenario, walls that sum to their
    total, a speedup that equals total/grid, and a bitwise C=1 slice."""
    sg = summary.get("scenario_grid")
    if not isinstance(sg, dict):
        return
    cfg = sg.get("config", {})
    seq = sg.get("sequential", {})
    rows = seq.get("per_scenario")
    names = cfg.get("scenarios")
    if isinstance(rows, list) and isinstance(names, list):
        got = [r.get("scenario") for r in rows if isinstance(r, dict)]
        if got != names:
            errors.append(f"scenario_grid/sequential: per_scenario covers "
                          f"{got} but config.scenarios is {names}")
    total = seq.get("total_s")
    if isinstance(rows, list) and isinstance(total, (int, float)):
        walls = [r.get("wall_s", 0) for r in rows if isinstance(r, dict)]
        tol = 0.01 + 5e-3 * len(walls)           # rounding headroom
        if abs(sum(walls) - total) > tol:
            errors.append(f"scenario_grid/sequential: walls sum to "
                          f"{sum(walls):.2f}s but total_s is {total}s")
    grid_wall = sg.get("grid", {}).get("wall_s")
    speedup = sg.get("speedup", {}).get("grid_vs_sequential")
    if isinstance(total, (int, float)) and isinstance(grid_wall,
                                                      (int, float)) \
            and isinstance(speedup, (int, float)) and grid_wall > 0:
        if abs(speedup - total / grid_wall) > 0.05 * max(speedup, 1.0):
            errors.append(f"scenario_grid/speedup: grid_vs_sequential "
                          f"{speedup} != total_s/grid.wall_s "
                          f"{total / grid_wall:.2f}")
    if sg.get("c1_slice_bitwise") is not True:
        errors.append("scenario_grid: c1_slice_bitwise must be true — "
                      "the grid's C=1 slice diverged from the "
                      "per-scenario fleet")


def validate_summary(summary: dict, schema_path: str = SCHEMA) -> list:
    """Return a list of violation strings for a loaded summary (empty =
    valid)."""
    with open(schema_path) as f:
        schema = json.load(f)
    try:
        import jsonschema
    except ImportError:
        errors: list = []
        _check(summary, schema, "", errors)
    else:
        validator = jsonschema.Draft7Validator(schema)
        errors = [f"{'/'.join(str(p) for p in e.absolute_path) or '$'}: "
                  f"{e.message}" for e in validator.iter_errors(summary)]
    _check_stage_chunks(summary, errors)
    _check_round_step(summary, errors)
    _check_scenario_grid(summary, errors)
    return errors


def validate(summary_path: str = DEFAULT_SUMMARY,
             schema_path: str = SCHEMA) -> list:
    """Return a list of violation strings (empty = valid)."""
    with open(summary_path) as f:
        summary = json.load(f)
    return validate_summary(summary, schema_path)


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else argv
    path = args[0] if args else DEFAULT_SUMMARY
    errors = validate(path)
    if errors:
        for e in errors:
            print(f"SCHEMA VIOLATION {e}")
        raise SystemExit(1)
    print(f"{os.path.relpath(path, ROOT)}: OK "
          f"(schema {os.path.relpath(SCHEMA, ROOT)})")


if __name__ == "__main__":
    main()
