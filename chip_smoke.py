#!/usr/bin/env python3
"""On-card smoke of the PyTorch + CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # from the root of a checkout, one NVIDIA GPU

Phases (any failure exits nonzero, and nothing is swallowed):

  1. the card's name and power limit (nvidia-smi); build the CUDA kernels
     from the checkout's sources (nvcc, sm_90a) and report the seconds;
  2. every kernel against its plain PyTorch version on the card, at the
     main path's shape (C = 7 cells, N = 10 devices, D = 814,090) and at
     ragged D in {1, 5000}: K1 ``ota_round_step`` with f32, bf16 and int8
     wires, K2 ``ota_aggregate`` with f32 and bf16; median times with CUDA
     events beside the plain version's and the byte bound;
  3. the main path at full width through ``repro_torch.fig2.run``:
     paper_mlp, 7 schemes, minibatch 128, flat, fused, f32 uplink, 30
     rounds with an eval every 10 -- K1 must launch once per round and the
     plain versions never; then the unfused path (K2 once per round) and
     the bf16 and int8 uplinks (K1 once per round), a few rounds each;
  4. the port on the card with its kernels against the same port with the
     kernels forced off, on the same draws, for 3 rounds (fused and
     unfused, f32 uplink): the params must agree to the f32 tolerance (an
     int8 wire is left out: a reordered f32 sum may move one gradient
     element across a quantizer boundary, a whole quantum, in later rounds);
  5. one JSON line ``{"kernels": [...]}``, then the last line
     ``{"ok": true, "device": {...}}``.

TF32 is off throughout (``repro_torch.device.resolve_device``): the
reference is full float32.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

F32_TOL = dict(rtol=2e-5, atol=2e-5)       # as tests/test_kernels.py
BF16_TOL = dict(rtol=6e-2, atol=6e-2)      # bf16 outputs, compared in f32
MAIN = (7, 10, 814_090)                    # cells, devices, d of the main path
RAGGED_D = (1, 5000)
ROUNDS, EVERY, BATCH = 30, 10, 128
SHORT = 5                                  # rounds of the other paths
# published peaks per card (data sheets): (device-memory bytes/s, f32 flop/s
# outside the tensor cores); an unknown name falls back to the H100 SXM
PEAKS = {"H100 PCIe": (2.0e12, 51e12), "H100 NVL": (3.9e12, 60e12),
         "H200": (4.8e12, 67e12), "H100": (3.35e12, 67e12)}
SOURCE = "src/repro_torch/kernels/csrc/ota_kernels.cu"
REPLACES = {"ota_round_step": "src/repro/kernels/round_step.py:53",
            "ota_aggregate": "src/repro/kernels/ota_aggregate.py:41"}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def peaks(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    return "H100 (assumed)", PEAKS["H100"]


def median_ms(torch, fn, iters=25, warmup=3):
    """Median of ``iters`` single-call times, each between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def phase_kernels(torch, dev, card):
    """Phase 2: every kernel against its plain version on the card."""
    from repro_torch.kernels import ops, ota_aggregate, ref, round_step
    _, (bw, f32_peak) = peaks(card)
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for (c, n, d) in [MAIN] + [(3, 10, dd) for dd in RAGGED_D]:
        main = (c, n, d) == MAIN
        g = torch.randn((c, n, d), generator=gen, device=dev)
        s = torch.rand((c, n), generator=gen, device=dev) * 0.2
        s[:, -1] = 0.0
        z = torch.randn((c, d), generator=gen, device=dev)
        p = torch.randn((c, d), generator=gen, device=dev)
        ns = torch.rand((c,), generator=gen, device=dev) * 0.1
        eta = torch.rand((c,), generator=gen, device=dev) * 0.1
        for wire in ("f32", "bf16", "int8"):
            w, qs = ops.quantize_uplink(g, wire)
            qs1 = torch.ones_like(s) if qs is None else qs

            def kern():
                return round_step.ota_round_step(w, qs1, s, z, ns, p, eta)

            def plain():
                return ref.ota_round_step_ref(w, s, z, ns, p, eta, qs)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = (got - want).abs()
            ok = bool((err <= F32_TOL["atol"]
                       + F32_TOL["rtol"] * want.abs()).all())
            row = {"max_abs_err": float(err.max()), "tol": F32_TOL, "ok": ok}
            if main:
                byts = nbytes(w, qs1, s, z, ns, p, eta, got)
                flops = c * d * (3 * n + 4)
                bound = 1e3 * max(byts / bw, flops / f32_peak)
                row.update(ms=median_ms(torch, kern),
                           plain_ms=median_ms(torch, plain),
                           bound_ms=bound, bytes=byts,
                           bound_by="bytes" if byts / bw >= flops / f32_peak
                           else "operations")
            results[("ota_round_step", wire, d)] = row
            print(f"  K1 ota_round_step {wire:>4} C={c} N={n} D={d}: "
                  + json.dumps(row), flush=True)
            check(ok, f"K1 {wire} D={d} disagrees with its plain version")
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            gd = g.to(dtype)

            def kern():
                return ota_aggregate.ota_aggregate(gd, s, z, ns)

            def plain():
                return ref.ota_aggregate_ref(gd, s, z, ns)
            got, want = kern().float(), plain().float()
            torch.cuda.synchronize()
            err = (got - want).abs()
            ok = bool((err <= tol["atol"] + tol["rtol"] * want.abs()).all())
            row = {"max_abs_err": float(err.max()), "tol": tol, "ok": ok}
            wire = "f32" if dtype == torch.float32 else "bf16"
            if main:
                byts = nbytes(gd, s, z, ns) + c * d * gd.element_size()
                flops = c * d * (2 * n + 2)
                bound = 1e3 * max(byts / bw, flops / f32_peak)
                row.update(ms=median_ms(torch, kern),
                           plain_ms=median_ms(torch, plain),
                           bound_ms=bound, bytes=byts,
                           bound_by="bytes" if byts / bw >= flops / f32_peak
                           else "operations")
            results[("ota_aggregate", wire, d)] = row
            print(f"  K2 ota_aggregate  {wire:>4} C={c} N={n} D={d}: "
                  + json.dumps(row), flush=True)
            check(ok, f"K2 {wire} D={d} disagrees with its plain version")
        del g, z, p
    return results


def counts():
    from repro_torch.kernels import ota_aggregate, ref, round_step
    return {"ota_round_step": round_step.ota_round_step.launches,
            "ota_aggregate": ota_aggregate.ota_aggregate.launches,
            "plain_round_step": ref.ota_round_step_ref.calls,
            "plain_aggregate": ref.ota_aggregate_ref.calls}


def zero_counts():
    from repro_torch.kernels import ota_aggregate, ref, round_step
    round_step.ota_round_step.launches = 0
    ota_aggregate.ota_aggregate.launches = 0
    ref.ota_round_step_ref.calls = 0
    ref.ota_aggregate_ref.calls = 0


def check_result(torch, np, res, rounds, label):
    k = len(res.names)
    for name, v in res.params.items():
        check(v.shape[:2] == (k, 1), f"{label}: params {name} {v.shape}")
        check(bool(torch.isfinite(v).all()), f"{label}: params {name} not finite")
    for name, v in res.traces.items():
        check(v.shape == (k, 1, rounds), f"{label}: trace {name} {v.shape}")
        check(bool(np.isfinite(v).all()), f"{label}: trace {name} not finite")


def round_ms(res):
    """Host wall per round (device-synchronized chunk ends), first chunk
    excluded (it holds the first launches)."""
    later = res.chunk_walls[1:] or res.chunk_walls
    return 1e3 * sum(sec for _, sec in later) / sum(r for r, _ in later)


def phase_main_path(torch, np, dev):
    """Phase 3: the port's main path at full width, then its other paths."""
    from repro_torch import fig2
    from repro_torch.fl.driver import run_fleet_task
    from repro_torch.tasks.image import make_paper_mlp
    zero_counts()
    hist, res = fig2.run(num_rounds=ROUNDS, eval_every=EVERY, seed=0,
                         batch_size=BATCH, uplink_dtype="f32", device=dev)
    torch.cuda.synchronize()
    main = counts()
    print(f"  main path (fused, f32 uplink): counts {main}", flush=True)
    check(main["ota_round_step"] == ROUNDS,
          f"K1 launched {main['ota_round_step']} times in {ROUNDS} rounds")
    check(main["ota_aggregate"] == 0, "K2 launched on the fused path")
    check(main["plain_round_step"] == 0 and main["plain_aggregate"] == 0,
          "a plain kernel version ran on the CUDA path")
    check_result(torch, np, res, ROUNDS, "main path")
    for name, h in hist.items():
        check(len(h) == len(res.evals) == 4, f"{name}: {len(h)} evals")
        print(f"  {name:>17}: acc " + " ".join(f"{r['acc']:.4f}" for r in h)
              + "  global_loss " + " ".join(f"{r['global_loss']:.4f}"
                                            for r in h), flush=True)
        check(all(0.0 <= r["acc"] <= 1.0 for r in h), f"{name}: acc range")
    ideal = hist["ideal"]
    check(ideal[-1]["global_loss"] < ideal[0]["global_loss"]
          and ideal[-1]["acc"] > ideal[0]["acc"],
          "ideal FedAvg did not learn over the main path's rounds")
    walls = {"fused_f32": round_ms(res)}
    print(f"  round wall {walls['fused_f32']:.3f} ms (host clock, chunk ends "
          f"synchronized; first chunk excluded); run wall {res.wall:.2f} s",
          flush=True)

    task = make_paper_mlp()
    dep, prm, td = fig2.build_world(task, 0)
    schemes = fig2.make_schemes(task, dep, prm)
    paths = {}
    for label, kw, kernel in (
            ("unfused_f32", {"fuse_round": False}, "ota_aggregate"),
            ("fused_bf16", {"uplink_dtype": "bf16"}, "ota_round_step"),
            ("fused_int8", {"uplink_dtype": "int8"}, "ota_round_step")):
        run = task.run_config(num_rounds=SHORT, eval_every=SHORT, seed=0,
                              batch_size=BATCH)
        zero_counts()
        r = run_fleet_task(task, schemes, dep.gains, run, task_data=td,
                           flat=True, device=dev, **kw)
        torch.cuda.synchronize()
        cnt = counts()
        print(f"  {label}: {SHORT} rounds, counts {cnt}, round wall "
              f"{round_ms(r):.3f} ms", flush=True)
        check(cnt[kernel] == SHORT, f"{label}: {kernel} launched "
              f"{cnt[kernel]} times in {SHORT} rounds")
        other = "ota_round_step" if kernel == "ota_aggregate" \
            else "ota_aggregate"
        check(cnt[other] == 0, f"{label}: {other} launched")
        check(cnt["plain_round_step"] == 0 and cnt["plain_aggregate"] == 0,
              f"{label}: a plain kernel version ran on the CUDA path")
        check_result(torch, np, r, SHORT, label)
        paths[label] = cnt
        walls[label] = round_ms(r)
    return main, paths, walls, (task, dep, td, schemes)


def phase_kernels_vs_plain_path(torch, dev, world):
    """Phase 4: same draws, kernels on vs forced off, 3 rounds."""
    from repro_torch.fl.driver import run_fleet_task
    task, dep, td, schemes = world
    worst = {}
    for label, kw in (("fused", {}), ("unfused", {"fuse_round": False})):
        run = task.run_config(num_rounds=3, eval_every=3, seed=0,
                              batch_size=BATCH)
        on = run_fleet_task(task, schemes, dep.gains, run, task_data=td,
                            flat=True, device=dev, **kw)
        off = run_fleet_task(task, schemes, dep.gains, run, task_data=td,
                             flat=True, device=dev, use_kernel=False, **kw)
        err = 0.0
        for name in on.params:
            a, b = on.params[name], off.params[name]
            check(bool((torch.abs(a - b) <= F32_TOL["atol"]
                        + F32_TOL["rtol"] * torch.abs(b)).all()),
                  f"{label}: params {name} differ, kernels on vs off")
            err = max(err, float(torch.abs(a - b).max()))
        worst[label] = err
        print(f"  {label}: 3 rounds, kernels on vs off, max |dparams| "
              f"{err:.3e} (tol {F32_TOL})", flush=True)
    return worst


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels").is_dir():
        print(f"FAIL: no port under {SRC} (run from a checkout)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import numpy as np
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    t_start = time.time()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card_line = smi.stdout.strip().splitlines()[0]
    dev = resolve_device(None)
    card = torch.cuda.get_device_name(0)
    peak_name, (bw, f32_peak) = peaks(card)
    print(f"[1] card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | peaks of {peak_name}: {bw / 1e12} TB/s, "
          f"{f32_peak / 1e12} TFLOP/s f32", flush=True)
    t0 = time.time()
    lib = build.build(verbose=True)
    build.library()
    print(f"[1] built {lib.name} in {time.time() - t0:.2f} s", flush=True)

    print("[2] kernels vs plain versions on the card", flush=True)
    kres = phase_kernels(torch, dev, card)
    print("[3] main path at full width", flush=True)
    main_counts, path_counts, walls, world = phase_main_path(torch, np, dev)
    print("[4] kernels on vs forced off, same draws", flush=True)
    phase_kernels_vs_plain_path(torch, dev, world)

    launches = {("ota_round_step", "f32"): main_counts["ota_round_step"],
                ("ota_round_step", "bf16"):
                    path_counts["fused_bf16"]["ota_round_step"],
                ("ota_round_step", "int8"):
                    path_counts["fused_int8"]["ota_round_step"],
                ("ota_aggregate", "f32"):
                    path_counts["unfused_f32"]["ota_aggregate"]}
    kernels = []
    for (name, wire), n_launch in launches.items():
        row = kres[(name, wire, MAIN[2])]
        kernels.append({
            "name": f"{name}[{wire}]", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": n_launch,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None})
    agg_bf16 = kres[("ota_aggregate", "bf16", MAIN[2])]
    print(f"[5] ota_aggregate[bf16] (no path hands K2 a bf16 g): "
          f"{json.dumps(agg_bf16)}", flush=True)
    print(f"[5] round walls ms: {json.dumps(walls)}; total "
          f"{time.time() - t_start:.1f} s", flush=True)
    print(card_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
