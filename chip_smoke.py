#!/usr/bin/env python3
"""On-card smoke of the PyTorch + CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # from the root of a checkout, one NVIDIA GPU

Phases (any failure exits nonzero, and nothing is swallowed):

  1. the card's name and power limit (nvidia-smi); build the CUDA kernels
     from the checkout's sources (one nvcc per source, all at once, sm_90a)
     and report the seconds; read each kernel's SASS (``cuobjdump -sass``):
     count the 128-bit global loads and stores (LDG.E.128, STG.E.128) of
     every K1/K2 instance and the tensor-core instructions of the
     flash-attention and ssd_scan kernels (HGMMA for wgmma, HMMA for
     mma.sync), and fail if a K1/K2 instance has no 128-bit load or store,
     K3's bf16 kernel or K4's f32 kernel has no tensor-core instruction, or
     K3's f32 kernel (Dh 64 and 128) has no HMMA; print K3 f32's registers
     and spills (ptxas) and fail if it spills;
  2. every kernel against its plain PyTorch version on the card, at its
     main path's shapes, with times (CUDA events around batches of 20
     back-to-back calls, the median of 5 batches) beside the plain
     version's, the bound, and one PyTorch library call where there is one:
       - K1 ``ota_round_step`` (f32, bf16, int8 wires) and K2
         ``ota_aggregate`` (f32, bf16) at the fleet's C = 7 cells, N = 10
         devices, D = 814,090, and at ragged D in {1, 5000}: bitwise equal
         to the plain versions (which take the kernels' order of f32
         operations) and within the f32 / bf16 tolerance; the main shape's
         achieved GB/s and share of the byte bound beside its time;
       - K3 ``flash_attention`` at the serve path's prefill (B 8, S 1024,
         H = KH = 16, Dh 64, bf16, causal), at qwen3's heads (H 16, KH 8,
         Dh 128), with window 256, at ragged S = 1000, and in f32 (the
         serve path's prefill in f32, qwen3's heads, window 256) -- f32 to
         2e-5, bf16 to two bf16 ulps plus 1e-2; the shapes, the bound and
         the ``scaled_dot_product_attention`` call timed beside it are
         ``repro_torch.profile_attention``'s; the f32 bound takes the
         cheaper of the FMA units and 3xTF32;
       - K4 ``ssd_scan`` at the mamba2 prefill's scan (B 8, S 1024, H 64,
         P 64, N 128, G 1, f32, chunk 128), at ragged S = 1000, with
         G = 2 and a nonzero state0, with bf16 inputs, and at the smoke
         model's P = N = 32 -- y and the final state to 1e-4 of their
         largest magnitude plus 2e-4 relative (bf16 y: 1.6e-2); its
         bound takes the cheaper of the f32 FMA units and 3xTF32 on the
         tensor cores; no PyTorch call computes the scan, so no library
         time;
  3. the fleet's main path at full width through ``repro_torch.fig2.run``:
     paper_mlp, 7 schemes, minibatch 128, flat, fused, f32 uplink, 30
     rounds with an eval every 10 -- K1 must launch once per round and the
     plain versions never; then the unfused path (K2 once per round) and
     the bf16 and int8 uplinks (K1 once per round), a few rounds each;
  4. the fleet with its kernels against the same fleet with the kernels
     forced off, on the same draws, for 3 rounds (fused and unfused, f32
     uplink): the params must agree to the f32 tolerance (an int8 wire is
     left out: a reordered f32 sum may move one gradient element across a
     quantizer boundary, a whole quantum, in later rounds);
  5. the Fig.-2 path closed: (a) the ``sca`` design of the ported solver
     (``repro_torch.solvers``, float64 on the card) at the full-width
     Fig.-2 world against the reference's default design committed in
     ``experiments/fig2_reference/sca_design.json``: gamma, alpha and the
     chi thresholds within 1e-6 relative, the (P1) objective within 1e-9,
     and the design's wall beside the SLSQP design's (the schemes are
     designed once, before phase 3, and phases 3-5 use them); (b) ``repro_torch.curves``'s gate at full
     width: ``fig2.run`` for seeds 0-3, 150 rounds, an eval every 10, in
     both protocols -- minibatch 128 on the fused f32 path (K1 once per
     round, 150 a run, the plain versions never) and the paper's full
     batch (aggregated leaf by leaf: no OTA kernel and no plain OTA
     version, by design) -- each scheme's final accuracy, final global
     loss and mean accuracy over the seeds held against the reference's
     committed curves (``experiments/fig2_reference``); (c) kill and
     resume: the minibatch fleet for 30 rounds stopped after its first
     chunk (``max_chunks=1``) and resumed from its checkpoint, bitwise
     equal (params, traces, evals) to an uninterrupted run, K1 once per
     round each invocation ran;
  6. the LM serve path at full width through
     ``python -m repro_torch.launch.serve`` (qwen1.5-0.5b, 24 layers, bf16,
     batch 8, prompt 1,024, 32 decode tokens): K3 must launch 24 times per
     prefill and K3's plain version never; finite logits, tokens in range;
     then the same weights and prompts with K3 forced off: the first
     layer's attention within K3's bf16 tolerance, and the logits' max
     difference and the share of equal greedy tokens through 24 bf16
     layers, held to a drift tolerance; then the same model in float32
     (weights and compute, same draw), where every prefill attention is
     K3's f32 kernel: 24 launches per prefill and no plain attention,
     layer 0's attention on vs off within the f32 tolerance, the logits
     and greedy tokens to the same drift tolerance and share; then a
     2-layer sliding-window run (window 256 < prompt) decoding through the
     ring cache, its tokens held against a full forward over the generated
     sequence;
  7. the Mamba-2 serve path at full width through the same entry point
     (mamba2-1.3b, 48 layers, bf16, batch 8, prompt 1,024, 32 decode
     tokens): K4 must launch 48 times per prefill and K4's plain version,
     K3 and the OTA kernels never; finite logits, tokens in range; then
     the same weights and prompts with K4 forced off: the first layer's
     mixer output within two bf16 ulps; the whole model's logit drift and
     equal greedy tokens are printed as readings, and so is the share of
     greedy tokens of prefill + recurrent decode that one prefill (K4)
     over the prompt and the fed-back tokens reproduces; then the same
     model in float32 (weights and compute, same draw): layer 0 to the
     f32 SSD tolerance, the logits to the drift tolerance, the greedy
     tokens of K4 on vs off and of the state check (which holds K4's final
     state, the conv stash and the plain decode together) to the share of
     equal tokens;
  8. the heterogeneous-wireless path (``repro_torch.scenario_sweep``):
     (a) the theory sweep over all ten registered scenarios x (sca, lcpc,
     zero_bias), the sca designs one batched solve per fading family on
     the card, each row's bias, variance and objective within 1e-6
     relative of the reference's (``experiments/scenario_reference/
     theory_seed0.json``), and the grid's four sca designs within 1e-6 of
     the reference's per-scenario designs; (b) the full-width grid:
     paper_mlp (d = 814,090), the four ``SWEEP_FAMILIES`` x (sca, lcpc,
     zero_bias) x seeds 0-3 = 48 cells, full batch, flat, fused f32 tail,
     100 rounds with an eval every 20 -- K1 once a round, nothing else of
     the OTA tail -- then the same grid at seeds 4-7, and each (scenario,
     scheme)'s curve statistics over seeds 0-7 held by ``curves.gate``
     against the reference's committed grid (``scenario_sweep.GATE_SEEDS``
     says why eight); (c) bitwise:
     the R = 1 grid vs the disk_rayleigh fleet, the grid vs its four
     per-scenario fleets, 10 grid rounds with K1 forced off vs on, and 5
     unfused rounds (K2 once a round) with K2 forced off vs on; K1 alone
     against its plain version at C = 48 with whole cells of s = 0 and
     per-cell noise scales over four decades, bitwise, timed; (d)
     ``adaptive_sca`` on disk_markov at full width, seeds 0-3, 30 rounds
     with an eval every 10: a redesign at each chunk end before the last
     round (the reference's cadence ends chunks after rounds 0, 10, 20 and
     29: three redesigns), each moving the design by more than 1e-3
     relative and differently per seed, and the final state's
     redesign on the card within 1e-6 of the same call on the machine's
     CPU; (e) kill after chunk 1 and resume, bitwise (params, traces,
     evals, fading state), on a disk_markov fleet and on the grid; every
     wall printed beside the card's name and power limit;
  9. the single-run API at full width (paper_mlp, ``sca``): ``run_fl``
     for 30 rounds at minibatch 128 through K1 (once a round, the plain
     version never) and at full batch, each bitwise the K = S = 1
     ``run_fleet`` cell; ``run_fl_legacy`` (numpy minibatch stream, the
     batch copied host -> device every round) at full batch bitwise
     ``run_fl``; ``fig2.benchmark`` (``--bench``) at the reference's
     settings, 7 schemes x 150 rounds, an eval every 15: legacy full
     batch, fleet full batch, fleet minibatch 128 (K1 150 times), its
     ``wall_s`` and ``speedup`` printed;
 10. population mode at full width: (a) ``fig2.make_population
     (1_000_000)``'s cohorts of 50 at ticks 0-4 for seeds 0-1 and their
     gains bitwise the reference's committed ones
     (``experiments/population_reference/population.json``); (b)
     ``fig2.population_benchmark``: ``adaptive_sca``, cohort 50, minibatch
     128, fused f32 tail, 48 rounds, an eval every 16, a cohort (and a
     cohort redesign on the host) every 16 rounds, with stream on and off:
     bitwise in params, traces, cohorts and designs, K1 48 times per run
     and its plain version never, the stream/serial walls and staging
     walls printed; (c) the tick-0 cohort redesign within 1e-6 in gamma of
     the reference's; (d) full participation: the 10-device deployment as
     a population, cohort 10, ``sca``, 6 rounds, bitwise the plain fleet
     through K1; (e) a 200-device Gauss-Markov population (rho 0.95),
     cohort 50, a cohort every 4 rounds, 24 rounds, ``sca``: devices
     re-enter (counted), and a run stopped after 2 chunks and resumed is
     bitwise the uninterrupted one, re-entry table (``pop_last``,
     ``pop_state``) included; K1 at the cohort fleet's C = 1, N = 50,
     bitwise its plain version, timed;
 11. the cifar_conv fleet with run telemetry at full width (d = 268,650,
     N = 10, Dirichlet 0.3 shards padded to the largest, minibatch 32,
     K1 at [7, 10, 268,650]): (a) ``fig2.build_world("cifar_conv")``, its
     seven schemes designed at the task's step sizes, ``sca`` within 1e-6
     of the reference's committed design
     (``experiments/cifar_reference/sca_design.json``); (b) the curves:
     ``curves.run_port`` of cifar_conv, 150 rounds, an eval every 10, K1
     once a round, held by ``curves.gate`` against the reference's curves
     at seeds 0-3, or 0-7 when the gate's false-alarm rate over its 21
     comparisons at four seeds a side (printed) is over 10 %; (c) ``fig2.run
     (task="cifar_conv", telemetry=True)`` -- the path of ``fig2 --task
     cifar_conv --telemetry`` -- for 30 rounds with a checkpoint: params,
     the non-``bv_`` traces and the evals bitwise telemetry off, one
     ``chunk_exec`` per chunk, ``python -m repro_torch.telemetry.report``
     exits 0 and prints every section; (d) kill after chunk 1 and resume
     under telemetry: bitwise the uninterrupted run, one run id, no
     duplicate chunk span; (e) K1 (5 fused rounds) and K2 (5 unfused
     rounds) forced off vs on, bitwise; K1 against its plain version at
     the cifar shape, bitwise, timed beside its byte bound; (f) a short
     ``adaptive_sca`` population run under telemetry, stream on (the
     phase-10 world made Gauss-Markov, two cohorts): ``sca_solve`` events
     tagged with their chunk, ``cohort`` events with each drawn device's
     staleness, ``stage`` and ``stage_wait`` events; (g) the cifar
     round's kernel launches, device time and busy share
     (``profile_round.profile``), telemetry off, two runs of its fleet
     bitwise equal (cuDNN deterministic), and its gradients alone timed
     with deterministic cuDNN and with cuDNN's default algorithms (what the
     determinism costs); its walls on one line;
 12. one JSON line ``{"kernels": [...]}`` (K3 twice: bf16 with the bf16
     serve run's launches, f32 with the f32 run's; K1 f32 four times: the
     Fig.-2 main path's, the grid's, the cohort fleet's and the cifar
     fleet's), then the last line ``{"ok": true, "device": {...}}``.

TF32 is off throughout (``repro_torch.device.resolve_device``): the
fleet's reference is full float32.
"""
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

F32_TOL = dict(rtol=2e-5, atol=2e-5)       # as tests/test_kernels.py
BF16_TOL = dict(rtol=6e-2, atol=6e-2)      # bf16 outputs, compared in f32
# K3 in bf16: its scores, softmax and accumulator are f32 like its plain
# version's, so the two bf16 outputs may round one ulp apart (2**-8 of the
# value); 1.6e-2 relative is two ulps, and 1e-2 absolute stays well under
# a typical output at S ~ 1000 (|o| ~ sqrt(e / S) ~ 0.05-0.07 for
# unit-variance q, k, v), so a wrong row fails
ATTN_BF16_TOL = dict(rtol=1.6e-2, atol=1e-2)
MAIN = (7, 10, 814_090)                    # cells, devices, d of the main path
RAGGED_D = (1, 5000)
ROUNDS, EVERY, BATCH = 30, 10, 128
SHORT = 5                                  # rounds of the other paths
SOURCES = {"ota_round_step": "src/repro_torch/kernels/csrc/ota_kernels.cu",
           "ota_aggregate": "src/repro_torch/kernels/csrc/ota_kernels.cu",
           "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
           "ssd_scan": "src/repro_torch/kernels/csrc/ssd_scan.cu"}
REPLACES = {"ota_round_step": "src/repro/kernels/round_step.py:53",
            "ota_aggregate": "src/repro/kernels/ota_aggregate.py:41",
            "flash_attention": "src/repro/kernels/flash_attention.py:68",
            "ssd_scan": "src/repro/kernels/ssd_scan.py:69"}
# K3's shapes are repro_torch.profile_attention.SHAPES: the serve path's
# prefill at full width in bf16 ("main") and in f32 ("main_f32"), qwen3's
# heads, window 256, ragged S = 1000
# K4 shapes: (label, B, S, H, P, N, G, dtype, state0, chunk); the first is
# the mamba2 prefill's scan at full width
SSD_MAIN = ("main", 8, 1024, 64, 64, 128, 1, "f32", False, 128)
SSD_SHAPES = [SSD_MAIN,
              ("ragged_s1000", 8, 1000, 64, 64, 128, 1, "f32", False, 128),
              ("g2_state0", 8, 1024, 64, 64, 128, 2, "f32", True, 128),
              ("bf16_state0", 8, 1024, 64, 64, 128, 1, "bf16", True, 128),
              ("smoke_p32_n32", 2, 37, 16, 32, 32, 1, "f32", True, 32)]
# K4 sums terms as large as its largest output, in another order and over
# its own tile of 64 rows against the plain version's chunk of 128: f32
# agrees to ~1e-5 of the largest |y|, so y and the state are held at 1e-4
# of their largest magnitude plus 2e-4 relative (the reference's SSD
# tolerance); a bf16 y may then land one ulp apart: 1.6e-2 (two ulps)
SSD_SCALE_TOL = 1e-4
SSD_REL_TOL = {"f32": 2e-4, "bf16": 1.6e-2}
SERVE = dict(arch="qwen1.5-0.5b", batch=8, prompt_len=1024, decode_tokens=32)
SSD_SERVE = dict(arch="mamba2-1.3b", batch=8, prompt_len=1024,
                 decode_tokens=32)
# mamba2 with random weights amplifies a rounding difference through its
# 48 layers: in bf16 a one-ulp change at layer 0 grows to ~20-30 % of the
# largest logit, as far for two plain scans that differ only in their chunk
# length as for K4 against its plain version.  So the bf16 run's whole-model
# drift and token shares are printed readings; its layer-0 mixer is held to
# two bf16 ulps, and DRIFT_LOGITS_SHARE and EQUAL_TOKENS_MIN are held on the
# same model in float32, where a rounding difference stays ~1e-4 of the
# logits
SWA = dict(n_layers=2, window=256)   # over the arch's long-context variant
# full width, K3 on vs off on the same weights: the first layer's attention
# output to the bf16 tolerance; through 24 bf16 layers a one-ulp difference
# may grow, so the logits are held to a drift bound (a share of their
# largest magnitude) and greedy tokens to a share that agrees
DRIFT_LOGITS_SHARE = 0.05
EQUAL_TOKENS_MIN = 0.9
# phase 5: the reference's default sca design is held to 1e-6 relative in
# gamma, alpha and the thresholds and 1e-9 in the (P1) objective (the CPU
# port lands 5e-9 and 2e-16 from it; tests/test_torch_solvers.py); the
# curves at the reference's Fig.-2 protocol, over its seeds 0-3
SCA_RTOL, SCA_OBJECTIVE_RTOL = 1e-6, 1e-9
CURVE_SEEDS, RESUME_ROUNDS = (0, 1, 2, 3), 30
# phase 8: the scenario path.  The theory rows against the reference's at
# 1e-6 relative (the solver lands ~1e-8 from the reference's designs, the
# rows move less); the adaptive fleet's length, cadence and the design move
# it must show (the grid's settings are ``scenario_sweep``'s)
THEORY_RTOL = 1e-6
ADAPTIVE_ROUNDS, ADAPTIVE_EVERY, ADAPTIVE_MOVE = 30, 10, 1e-3
GRID_CELLS = 48                            # 4 scenarios x 3 schemes x 4 seeds


# phase 9: the single-run API and fig2 --bench at the reference's settings
# (150 rounds, an eval every 15; its three runs take ~10-20 s here)
SINGLE_ROUNDS, BENCH_ROUNDS, BENCH_EVERY = 30, 150, 15
# phase 10: the population benchmark at cohort_rounds 16 (its default of 1
# would take 96 cohort redesigns of 4-15 s each: it runs on its own as
# ``python -m repro_torch.fig2 --bench --population 1000000``), the
# full-participation identity's 6 rounds, and the re-entry run
POP_SIZE, POP_COHORT, POP_ROUNDS, POP_EVERY = 1_000_000, 50, 48, 16
POP_COHORT_ROUNDS, FULL_ROUNDS = 16, 6
REENTRY = dict(size=200, rho=0.95, cohort=50, cohort_rounds=4, rounds=24,
               every=8, max_chunks=2)
REDESIGN_RTOL = 1e-6
# phase 11: the cifar_conv fleet with run telemetry.  Its world is
# paper_mlp's deployment with the convnet's d (268,650); K1 reads
# [C, N, D] = [7, 10, 268,650]; its curves run at the reference's cadence
# and the task's minibatch 32.  The gate widens from seeds 0-3 to 0-7 when
# its false-alarm rate at four seeds a side is over CIFAR_FALSE_ALARM_MAX
# (scenario_sweep.gate_false_alarm on the reference's curves)
CIFAR = (7, 10, 268_650)
CIFAR_BATCH, CIFAR_PROTOCOL = 32, "minibatch32"
CIFAR_FALSE_ALARM_MAX = 0.10
TEL_ROUNDS = 30
# the population run under telemetry: the phase-10 world made Gauss-Markov
# (so each cohort event carries the staleness of its devices off the
# re-entry table), adaptive_sca, stream on, two cohorts of 50
POP_TEL = dict(rho=0.95, rounds=8, every=4, cohort_rounds=4)
REPORT_SECTIONS = ("== run ", "== staging-lane timeline", "== SCA solver",
                   "== bias--variance trajectory", "== cohort staleness",
                   "== recompilation audit")


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def sass_ops(build, name, ops=("HGMMA", "HMMA")):
    """{kernel symbol: {op: n}} for the built library of ``csrc/<name>.cu``,
    read from its SASS (cuobjdump -sass); the defaults are the tensor-core
    instructions (HGMMA for wgmma, HMMA for mma.sync)."""
    exe = Path(build.nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(exe), "-sass", str(build.library_path(name))],
                         capture_output=True, text=True, timeout=120)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr}")
    pattern = re.compile(r"\b(" + "|".join(map(re.escape, ops)) + r")\b")
    found, fn = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            found[fn] = dict.fromkeys(ops, 0)
        elif fn is not None:
            op = pattern.search(line)
            if op:
                found[fn][op.group(1)] += 1
    return found


def ota_timing(kern, plain, byts, flops, bw, f32_peak):
    """Times, bound and achieved rate of a K1/K2 call at the main shape."""
    from repro_torch.card import median_ms
    ms = median_ms(kern)
    bound = 1e3 * max(byts / bw, flops / f32_peak)
    return {"ms": ms, "plain_ms": median_ms(plain), "bound_ms": bound,
            "bytes": byts, "gb_per_s": byts / ms / 1e6,
            "bound_share": bound / ms,
            "bound_by": "bytes" if byts / bw >= flops / f32_peak
            else "operations"}


def phase_kernels(torch, dev, card):
    """Phase 2: K1 and K2 against their plain versions on the card."""
    from repro_torch.card import peaks
    from repro_torch.kernels import ota_aggregate, round_step
    from repro_torch.profile_ota import draw, ota_cases
    _, (bw, f32_peak, _) = peaks(card)
    wrappers = {"ota_round_step": ("K1", round_step.ota_round_step),
                "ota_aggregate": ("K2", ota_aggregate.ota_aggregate)}
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for (c, n, d) in [MAIN] + [(3, 10, dd) for dd in RAGGED_D]:
        for name, wire, args, plain, byts, flops in ota_cases(
                *draw((c, n, d), dev, gen)):
            k, fn = wrappers[name]

            def kern(fn=fn, args=args):
                return fn(*args)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            tol = BF16_TOL if got.dtype == torch.bfloat16 else F32_TOL
            bitwise = bool(torch.equal(got, want))
            got, want = got.float(), want.float()
            err = (got - want).abs()
            ok = bool((err <= tol["atol"] + tol["rtol"] * want.abs()).all())
            row = {"max_abs_err": float(err.max()), "tol": tol, "ok": ok,
                   "bitwise": bitwise}
            if (c, n, d) == MAIN:
                row.update(ota_timing(kern, plain, byts, flops, bw, f32_peak))
            results[(name, wire, d)] = row
            print(f"  {k} {name:<14} {wire:>4} C={c} N={n} D={d}: "
                  + json.dumps(row), flush=True)
            check(ok, f"{k} {wire} D={d} disagrees with its plain version")
            check(bitwise, f"{k} {wire} D={d} is not bitwise equal to its "
                  "plain version")
    return results


def counts():
    from repro_torch.kernels import ota_aggregate, ref, round_step
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    return {"ota_round_step": round_step.ota_round_step.launches,
            "ota_aggregate": ota_aggregate.ota_aggregate.launches,
            "flash_attention": flash_attention.launches,
            "ssd_scan": ssd_scan.launches,
            "plain_round_step": ref.ota_round_step_ref.calls,
            "plain_aggregate": ref.ota_aggregate_ref.calls,
            "plain_attention": ref.attention_ref.calls,
            "plain_ssd": ref.ssd_chunked.calls}


def zero_counts():
    from repro_torch.kernels import ota_aggregate, ref, round_step
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_scan import ssd_scan
    round_step.ota_round_step.launches = 0
    ota_aggregate.ota_aggregate.launches = 0
    flash_attention.launches = 0
    ssd_scan.launches = 0
    ref.ota_round_step_ref.calls = 0
    ref.ota_aggregate_ref.calls = 0
    ref.attention_ref.calls = 0
    ref.ssd_chunked.calls = 0


def phase_attention_kernel(torch, dev, card):
    """Phase 2, K3: flash attention against its plain version on the card,
    with scaled_dot_product_attention timed beside it."""
    from repro_torch.card import median_ms
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.profile_attention import SHAPES, bound, draw, sdpa
    gen = torch.Generator(device=dev).manual_seed(1)
    results = {}
    for shape in SHAPES:
        label, b, s, h, kh, dh, dt, window = shape
        tol = ATTN_BF16_TOL if dt == "bf16" else F32_TOL
        q, k, v = draw(shape, dev, gen)

        def kern():
            return flash_attention(q, k, v, causal=True, window=window)

        def plain():
            return ref.attention_ref(q, k, v, causal=True, window=window)
        got, want = kern().float(), plain().float()
        torch.cuda.synchronize()
        err = (got - want).abs()
        ok = bool((err <= tol["atol"] + tol["rtol"] * want.abs()).all())
        library = sdpa(q, k, v, window)
        lib_err = float((library().float() - want).abs().max())
        row = {"shape": [b, s, h, kh, dh], "dtype": dt, "window": window,
               "max_abs_err": float(err.max()), "tol": tol, "ok": ok,
               "ms": median_ms(kern),
               "plain_ms": median_ms(plain),
               "library_ms": median_ms(library),
               "library_max_abs_err": lib_err, **bound(shape, card)}
        results[label] = row
        print(f"  K3 flash_attention {label}: " + json.dumps(row), flush=True)
        check(ok, f"K3 {label} disagrees with its plain version")
        del q, k, v, got, want
    return results


def ssd_flops(b, s, h, p, n, g, state0):
    """Fewest operations of the SSD scan on these inputs: the chunked form
    at the tile length q that minimises them (the form is exact for any q;
    K4 walks tiles of 64).  Per tile: C B^T once per group and att (dt x)
    per head over the causal triangle, C S_in (none on the first tile
    without a state in), the state's decay and its update B^T (dt x)."""
    def at(q):
        full, r = divmod(s, q)
        pairs = full * q * (q + 1) // 2 + r * (r + 1) // 2
        carried = 0 if state0 else 1          # the first tile's state is 0
        return (2 * b * pairs * (g * n + h * p)
                + 2 * b * h * n * p * (2 * s - carried * min(q, s))
                + b * h * n * p * (full + (r > 0) - carried))
    return min(at(q) for q in range(1, s + 1))


def phase_ssd_kernel(torch, dev, card):
    """Phase 2, K4: the SSD scan against its plain version on the card."""
    import torch.nn.functional as F
    from repro_torch.card import median_ms, peaks
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    _, (bw, f32_peak, bf16_peak) = peaks(card)
    gen = torch.Generator(device=dev).manual_seed(2)
    results = {}
    for label, b, s, h, p, n, g, dt_name, state, chunk in SSD_SHAPES:
        dtype = torch.bfloat16 if dt_name == "bf16" else torch.float32

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        x = randn(b, s, h, p).to(dtype)
        dt = F.softplus(randn(b, s, h)).to(dtype)
        a_neg = -torch.exp(0.5 * randn(h))
        bm, cm = ((0.5 * randn(b, s, g, n)).to(dtype) for _ in range(2))
        s0 = randn(b, h, p, n) if state else None

        def kern():
            return ssd_scan(x, dt, a_neg, bm, cm, chunk=chunk, state0=s0)

        def plain():
            return ref.ssd_chunked(x, dt, a_neg, bm, cm, chunk, state0=s0)
        (y, st), (want_y, want_st) = kern(), plain()
        torch.cuda.synchronize()
        ok, errs = True, {}
        for name, got, want, rel in (("y", y, want_y, SSD_REL_TOL[dt_name]),
                                     ("state", st, want_st,
                                      SSD_REL_TOL["f32"])):
            got, want = got.float(), want.float()
            err = (got - want).abs()
            scale = float(want.abs().max())
            ok &= bool((err <= SSD_SCALE_TOL * scale
                        + rel * want.abs()).all())
            errs[name] = (float(err.max()), scale)
        byts = nbytes(x, dt, a_neg, bm, cm, s0, y, st)
        flops = ssd_flops(b, s, h, p, n, g, state)
        # the products may run in f32 on the FMA units or as three TF32
        # products on the tensor cores, whichever takes less time
        ops_s = min((flops / f32_peak, "f32 FMA"),
                    (3 * flops / (bf16_peak / 2), "3xTF32 tensor cores"))
        row = {"shape": [b, s, h, p, n, g], "dtype": dt_name,
               "state0": state, "chunk": chunk,
               "max_abs_err": errs["y"][0], "max_abs_y": errs["y"][1],
               "state_max_abs_err": errs["state"][0],
               "max_abs_state": errs["state"][1],
               "tol": {"scale": SSD_SCALE_TOL, "rtol": SSD_REL_TOL[dt_name]},
               "ok": ok, "ms": median_ms(kern),
               "plain_ms": median_ms(plain), "library_ms": None,
               "bound_ms": 1e3 * max(byts / bw, ops_s[0]),
               "bytes": byts, "flops": flops,
               "bound_by": "bytes" if byts / bw >= ops_s[0]
               else "operations", "operations_on": ops_s[1],
               "f32_fma_bound_ms": 1e3 * max(byts / bw, flops / f32_peak)}
        results[label] = row
        print(f"  K4 ssd_scan {label}: " + json.dumps(row), flush=True)
        check(ok, f"K4 {label} disagrees with its plain version")
        del x, dt, bm, cm, s0, y, st, want_y, want_st
    return results


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


def design_world(torch, dev):
    """paper_mlp's Fig.-2 world (data seed 0; the designs do not depend on
    it) and its seven schemes, designed once for phases 3-5.  ``sca`` is
    the ported solver's design on the card, timed; the SLSQP design it
    replaced as the default (``method="scipy"``, on the host) is timed
    beside it, and only timed."""
    from repro_torch import fig2, tasks
    from repro_torch.core import power_control as pcm
    task = tasks.get("paper_mlp", expect_runtime="fleet")
    dep, prm, td = fig2.build_world(task, 0)
    torch.cuda.synchronize()
    t0 = time.time()
    sca = fig2.make_schemes(task, dep, prm, ["sca"], device=dev)[0]
    torch.cuda.synchronize()
    walls = {"torch_card": time.time() - t0}
    t0 = time.time()
    pcm.make_sca(dep, prm.replace(eta=task.eta_for("sca", float(prm.eta))),
                 method="scipy")
    walls["scipy_host"] = time.time() - t0
    rest = [n for n in fig2.SCHEMES if n != "sca"]
    others = dict(zip(rest, fig2.make_schemes(task, dep, prm, rest,
                                              device=dev)))
    schemes = [sca if n == "sca" else others[n] for n in fig2.SCHEMES]
    print(f"  schemes designed once for phases 3-5: sca (torch f64 solver, "
          f"card) {walls['torch_card']:.3f} s; the SLSQP design (host) "
          f"{walls['scipy_host']:.3f} s", flush=True)
    return {"task": task, "dep": dep, "prm": prm, "td": td,
            "schemes": schemes, "design_s": walls}


def phase_main_path(torch, np, dev, world):
    """Phase 3: the port's main path at full width, then its other paths."""
    from repro_torch import fig2
    from repro_torch.fl.driver import run_fleet_task
    zero_counts()
    hist, res = fig2.run(num_rounds=ROUNDS, eval_every=EVERY, seed=0,
                         batch_size=BATCH, uplink_dtype="f32",
                         designs=world["schemes"], device=dev)
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

    task, dep, td, schemes = (world[k] for k in ("task", "dep", "td",
                                                 "schemes"))
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
    return main, paths, walls


def phase_kernels_vs_plain_path(torch, dev, world):
    """Phase 4: same draws, kernels on vs forced off, 3 rounds."""
    from repro_torch.fl.driver import run_fleet_task
    task, dep, td, schemes = (world[k] for k in ("task", "dep", "td",
                                                 "schemes"))
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


def phase_curves(torch, np, dev, world):
    """Phase 5: the sca design against the reference's, the curves' gate in
    both protocols, and kill and resume, all at full width."""
    import tempfile
    from repro_torch import curves, fig2
    from repro_torch.core import theory
    from repro_torch.fl.driver import run_fleet_task

    with open(ROOT / "experiments" / "fig2_reference" / "sca_design.json") as f:
        want = json.load(f)
    task, dep, prm, td, designs = (world[k] for k in ("task", "dep", "prm",
                                                      "td", "schemes"))
    check(task.param_dim == int(want["d"]) == MAIN[2],
          f"paper_mlp d {task.param_dim} vs the design's {want['d']}")
    prm_sca = prm.replace(eta=task.eta_for("sca", float(prm.eta)))
    check(prm_sca.eta == float(want["eta"]), "sca's eta differs")
    sca = designs[fig2.SCHEMES.index("sca")]
    design_s = world["design_s"]
    errs = {"gamma": _rel(np, sca.gamma, want["gamma"]),
            "alpha": _rel(np, sca.alpha, want["alpha"]),
            "thresholds": _rel(np, sca.thresholds, want["thresholds"]),
            "objective": _rel(np, theory.p1_objective(sca.gamma, prm_sca),
                              want["objective"])}
    print(f"  sca design on the card (repro_torch.solvers, f64): wall "
          f"{design_s['torch_card']:.3f} s (SLSQP on the host "
          f"{design_s['scipy_host']:.3f} s); relative error against the reference's "
          f"default design {json.dumps(errs)} (tol {SCA_RTOL}, objective "
          f"{SCA_OBJECTIVE_RTOL})", flush=True)
    for name in ("gamma", "alpha", "thresholds"):
        check(errs[name] <= SCA_RTOL, f"sca {name} off the reference's by "
              f"{errs[name]:.3e}")
    check(errs["objective"] <= SCA_OBJECTIVE_RTOL, "sca objective off the "
          f"reference's by {errs['objective']:.3e}")

    report, walls = {}, {}
    for protocol, batch in curves.PROTOCOLS.items():
        runs = []

        def after(seed, res, protocol=protocol, runs=runs):
            torch.cuda.synchronize()
            runs.append((seed, counts(), round_ms(res), res.wall))
            zero_counts()
            check_result(torch, np, res, curves.ROUNDS,
                         f"{protocol} seed {seed}")
        zero_counts()
        port = curves.run_port(protocol, CURVE_SEEDS, dev, designs,
                               after_run=after)
        for seed, cnt, ms, wall in runs:
            print(f"  {protocol} seed {seed}: {curves.ROUNDS} rounds, round "
                  f"wall {ms:.3f} ms, run wall {wall:.2f} s, counts {cnt}",
                  flush=True)
            ota = {k: cnt[k] for k in ("ota_round_step", "ota_aggregate",
                                       "plain_round_step", "plain_aggregate")}
            if batch:
                check(ota == {"ota_round_step": curves.ROUNDS,
                              "ota_aggregate": 0, "plain_round_step": 0,
                              "plain_aggregate": 0},
                      f"{protocol} seed {seed}: K1 must launch once a round "
                      f"and nothing else of the OTA tail run: {ota}")
            else:
                check(not any(ota.values()),
                      f"{protocol} seed {seed}: the per-leaf tail ran an "
                      f"OTA kernel or its plain version: {ota}")
        if not batch:
            print(f"  {protocol}: no OTA kernel launched, by design (the "
                  "paper's protocol aggregates leaf by leaf)", flush=True)
        walls[protocol] = [ms for _, _, ms, _ in runs]
        rows = curves.gate(port, curves.load_reference(protocol,
                                                       CURVE_SEEDS))
        print(curves.table(rows, f"  {protocol}: port (this card) vs "
                           f"reference (CPU), seeds {list(CURVE_SEEDS)}, "
                           f"{curves.ROUNDS} rounds"), flush=True)
        report[protocol] = rows
    fails = [f"{p}/{r['scheme']}/{r['stat']}" for p, rows in report.items()
             for r in rows if not r["ok"]]
    check(not fails, f"curves outside the gate: {fails}")

    run = task.run_config(num_rounds=RESUME_ROUNDS, eval_every=EVERY, seed=0,
                          batch_size=BATCH)
    kw = dict(task_data=td, flat=True, device=dev)
    launched = {}
    zero_counts()
    whole = run_fleet_task(task, designs, dep.gains, run, **kw)
    torch.cuda.synchronize()
    launched["whole"] = counts()["ota_round_step"]
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "fleet")
        zero_counts()
        first = run_fleet_task(task, designs, dep.gains, run,
                               checkpoint_path=path, max_chunks=1, **kw)
        torch.cuda.synchronize()
        launched["first"] = counts()["ota_round_step"]
        zero_counts()
        rest = run_fleet_task(task, designs, dep.gains, run,
                              checkpoint_path=path, resume=True, **kw)
        torch.cuda.synchronize()
        launched["resumed"] = counts()["ota_round_step"]
    executed = {"whole": RESUME_ROUNDS,
                "first": sum(n for n, _ in first.chunk_walls),
                "resumed": sum(n for n, _ in rest.chunk_walls)}
    check(executed["first"] + executed["resumed"] == RESUME_ROUNDS
          and executed["first"] < RESUME_ROUNDS, f"rounds run {executed}")
    check(launched == executed, f"K1 launches {launched} vs rounds run "
          f"{executed}")
    bitwise = {"params": all(torch.equal(whole.params[k], rest.params[k])
                             for k in whole.params),
               "traces": set(whole.traces) == set(rest.traces) and all(
                   np.array_equal(whole.traces[k], rest.traces[k])
                   for k in whole.traces),
               "evals": [t for t, _ in whole.evals]
               == [t for t, _ in rest.evals] and all(
                   np.array_equal(a[k], b[k])
                   for (_, a), (_, b) in zip(whole.evals, rest.evals)
                   for k in a)}
    print(f"  kill and resume: {RESUME_ROUNDS} rounds, stopped after chunk 1 "
          f"and resumed; rounds run {executed}, K1 launches {launched}; "
          f"bitwise equal to the uninterrupted run {json.dumps(bitwise)}",
          flush=True)
    check(all(bitwise.values()), f"resumed run differs: {bitwise}")
    return {"design_s": design_s, "design_err": errs, "round_ms": walls,
            "gate": {p: all(r["ok"] for r in rows)
                     for p, rows in report.items()}}


def _rel(np, got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))


def k1_value_patterns(torch, dev, card):
    """K1 against its plain version at the grid's C = 48 cells with the
    values the scenarios bring: whole cells of s = 0 (every device
    dropped), dropped devices inside cells, and per-cell noise scales
    spread over four decades; bitwise, with times."""
    def patterns(s, ns, gen):
        s[::4] = 0.0                               # whole cells dropped
        s[1::4, ::3] = 0.0                         # dropped devices
        ns = 10.0 ** (4.0 * torch.rand((s.shape[0],), generator=gen,
                                       device=s.device) - 3.0)
        return s, ns
    return k1_row(torch, dev, card, (GRID_CELLS, MAIN[1], MAIN[2]),
                  "the grid's (whole cells of s = 0, per-cell noise "
                  "scales 1e-3..10)", 8, patterns)


def k1_row(torch, dev, card, shape, label, seed, patterns=None):
    """K1 against its plain version at ``shape`` (C, N, D), bitwise, with
    times, its bound and the achieved rate.  ``patterns(s, ns, gen)``,
    where given, edits the drawn values first and returns (s, ns)."""
    from repro_torch.card import peaks
    from repro_torch.kernels import ref, round_step
    from repro_torch.profile_ota import draw
    _, (bw, f32_peak, _) = peaks(card)
    gen = torch.Generator(device=dev).manual_seed(seed)
    c, n, d = shape
    g, s, z, ns, p, eta = draw((c, n, d), dev, gen)
    if patterns is not None:
        s, ns = patterns(s, ns, gen)
    args = (g, torch.ones_like(s), s, z, ns, p, eta)

    def kern():
        return round_step.ota_round_step(*args)

    def plain():
        return ref.ota_round_step_ref(g, s, z, ns, p, eta, None)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    row = {"max_abs_err": float((got - want).abs().max()),
           "bitwise": bool(torch.equal(got, want)),
           **ota_timing(kern, plain, nbytes(*args) + c * d * 4,
                        c * d * (3 * n + 4), bw, f32_peak)}
    print(f"  K1 f32 at {label} C={c}, N={n}, D={d}: {json.dumps(row)}",
          flush=True)
    check(row["bitwise"], f"K1 is not bitwise its plain version at {label}")
    return row


def phase_single_run(torch, np, dev, world, card_line):
    """Phase 9: ``run_fl`` (K = S = 1) through K1 against the one-cell
    fleet, the legacy host loop at full batch against ``run_fl``, and
    ``fig2.benchmark`` at the reference's settings."""
    from repro_torch import fig2, validate_bench
    from repro_torch.fl.driver import run_fleet
    from repro_torch.fl.server import run_fl, run_fl_legacy
    task, dep, td, designs = (world[k] for k in ("task", "dep", "td",
                                                 "schemes"))
    sca = designs[fig2.SCHEMES.index("sca")]
    p0, ev = task.init_params(0, dev), task.make_eval(td, dev)
    walls, out = {}, {}
    for label, batch, flat in (("minibatch", BATCH, True),
                               ("full_batch", 0, False)):
        run = task.run_config(eta=task.eta_for("sca", 0.05),
                              num_rounds=SINGLE_ROUNDS, eval_every=EVERY,
                              seed=0, batch_size=batch)
        zero_counts()
        params, hist = run_fl(task.loss_fn, p0, sca, dep.gains, td.train,
                              run, ev, flat=flat, device=dev)
        torch.cuda.synchronize()
        cnt = _ota_counts()
        res = run_fleet(task.loss_fn, p0, [sca], dep.gains, td.train, run,
                        ev, flat=flat, seeds=(0,), device=dev)
        same = all(torch.equal(params[k], res.params[k][0, 0])
                   for k in params) and all(
            np.array_equal(hist.traces[k], v[0, 0])
            for k, v in res.traces.items())
        print(f"  run_fl sca, {label}, {SINGLE_ROUNDS} rounds: counts {cnt}; "
              f"bitwise the K = S = 1 run_fleet cell: {same}; final acc "
              f"{hist[-1]['acc']:.4f}", flush=True)
        check(same, f"run_fl ({label}) differs from its one-cell fleet")
        want = {"ota_round_step": SINGLE_ROUNDS if flat else 0,
                "ota_aggregate": 0, "plain_round_step": 0,
                "plain_aggregate": 0}
        check(cnt == want, f"run_fl ({label}) counts {cnt}, want {want}")
        out[label] = (params, hist, run, cnt)
    params, hist, run, _ = out["full_batch"]
    torch.cuda.synchronize()
    t0 = time.time()
    lparams, lhist = run_fl_legacy(task.loss_fn, p0, sca, dep.gains,
                                   td.train, run, ev, device=dev)
    torch.cuda.synchronize()
    walls["legacy_full_batch_s"] = time.time() - t0
    same = all(torch.equal(params[k], lparams[k]) for k in params) and all(
        a[k] == b[k] for a, b in zip(hist, lhist)
        for k in ("acc", "global_loss", "round", "active")) \
        and len(hist) == len(lhist)
    print(f"  run_fl_legacy sca, full batch, {SINGLE_ROUNDS} rounds (the "
          f"batch copied host -> device every round): bitwise run_fl: "
          f"{same}, {walls['legacy_full_batch_s']:.3f} s", flush=True)
    check(same, "run_fl_legacy at full batch differs from run_fl")

    zero_counts()
    t0 = time.time()
    rep = fig2.benchmark(num_rounds=BENCH_ROUNDS, eval_every=BENCH_EVERY,
                         seed=0, batch_size=BATCH, task=task, log=False,
                         designs=designs, device=dev)
    torch.cuda.synchronize()
    cnt = _ota_counts()
    walls["bench_s"] = time.time() - t0
    print(f"  fig2 --bench, {len(fig2.SCHEMES)} schemes x {BENCH_ROUNDS} "
          f"rounds, an eval every {BENCH_EVERY}: wall_s "
          f"{json.dumps(rep['wall_s'])}; speedup "
          f"{json.dumps(rep['speedup'])}; legacy vs fleet at full batch, "
          f"max |delta| {json.dumps(rep['equivalence']['max_abs_delta'])} "
          f"(read: the fleet's 7-cell GEMMs may round apart from the "
          f"legacy's one-cell ones); counts {cnt} [{card_line}]", flush=True)
    check(cnt == {"ota_round_step": BENCH_ROUNDS, "ota_aggregate": 0,
                  "plain_round_step": 0, "plain_aggregate": 0},
          f"fig2 --bench: only its minibatch fleet launches K1, once a "
          f"round: {cnt}")
    check(all(np.isfinite(v) and v > 0 for block in ("wall_s", "speedup")
              for v in rep[block].values()), "fig2 --bench walls")
    errors = validate_bench.validate_summary(
        fig2.bench_summary(rep, task.name, "chip_smoke phase 9"))
    print(f"  its summary against bench_schema.json: {errors or 'valid'}",
          flush=True)
    check(not errors, f"fig2 --bench summary violates the schema: {errors}")
    walls.update(bench_wall_s=rep["wall_s"], bench_speedup=rep["speedup"],
                 bench_max_abs_delta=rep["equivalence"]["max_abs_delta"])
    return walls


def phase_population(torch, np, dev, card, card_line, world):
    """Phase 10: population mode at full width -- the reference's cohorts
    of the 1M-device population, the population benchmark (adaptive_sca,
    stream against serial, the full-participation identity) through K1,
    the tick-0 cohort redesign against the reference's, and re-entry with
    kill and resume on a Gauss-Markov population."""
    import tempfile
    from repro_torch import fig2, scenario_sweep as ss, validate_bench
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core import power_control as pcm, scenarios as scn
    from repro_torch.fl.driver import run_fleet_task
    t_phase = time.time()
    with open(ROOT / "experiments" / "population_reference"
              / "population.json") as f:
        ref = json.load(f)
    t0 = time.time()
    pop = fig2.make_population(POP_SIZE)
    same = {}
    for key, c in ref["cohorts"].items():
        seed, tick = map(int, key.split("/"))
        idx = pop.draw_cohort(ref["cohort"], tick, seed)
        same[key] = bool(np.array_equal(idx, c["idx"]) and np.array_equal(
            pop.gains_of(idx), np.asarray(c["gains"], np.float64)))
    print(f"  (a) make_population({POP_SIZE}): cohorts of {ref['cohort']} at "
          f"(seed/tick) {sorted(same)} and their gains bitwise the "
          f"reference's: {json.dumps(same)}; {time.time() - t0:.3f} s",
          flush=True)
    check(pop.describe() == ref["describe"] and all(same.values()),
          f"cohorts differ from the reference's: {same}")

    task = world["task"]
    sca10 = world["schemes"][fig2.SCHEMES.index("sca")]
    zero_counts()
    rep = fig2.population_benchmark(
        task=task, size=POP_SIZE, cohort=POP_COHORT, num_rounds=POP_ROUNDS,
        eval_every=POP_EVERY, cohort_rounds=POP_COHORT_ROUNDS, seed=0,
        batch_size=BATCH, log=False, full_schemes=[sca10], device=dev)
    torch.cuda.synchronize()
    cnt = _ota_counts()
    errors = validate_bench.validate_summary(
        fig2.bench_summary(rep, task.name, "chip_smoke phase 10"))
    res = rep.pop("result")
    print(f"  (b) population_benchmark: adaptive_sca, cohort {POP_COHORT}, "
          f"minibatch {BATCH}, fused f32 tail, {POP_ROUNDS} rounds, an eval "
          f"every {POP_EVERY}, cohort_rounds {POP_COHORT_ROUNDS}: designs at "
          f"rounds {[t for t, _ in res.designs]}; wall_s "
          f"{json.dumps(rep['wall_s'])}; stage walls per chunk "
          f"{json.dumps(rep['stage_chunks_s'])}; round ms "
          f"{json.dumps(rep['round_ms'])}; rounds/s "
          f"{rep['rounds_per_sec']:.3f}; overlap saving "
          f"{rep['overlap_saving_s']:.3f} s; stream bitwise serial "
          f"{rep['stream_bitwise']}; launches {json.dumps(rep['launches'])};"
          f" counts {cnt} [{card_line}]", flush=True)
    print(f"  (d) full participation (the 10-device deployment as a "
          f"population, cohort 10, sca, {FULL_ROUNDS} rounds, minibatch "
          f"{BATCH}) bitwise the plain fleet: {rep['full_cohort_bitwise']}",
          flush=True)
    print(f"  its summary against bench_schema.json: {errors or 'valid'}",
          flush=True)
    check(not errors, f"population benchmark summary violates the schema: "
          f"{errors}")
    check(rep["stream_bitwise"], "stream and serial differ")
    check(rep["full_cohort_bitwise"], "full participation differs from "
          "the plain fleet")
    for label in ("stream", "serial"):
        check(rep["launches"][label] == {"ota_round_step": POP_ROUNDS,
                                         "plain_round_step": 0},
              f"{label}: K1 must launch once a round and its plain version "
              f"never: {rep['launches'][label]}")
    check(rep["launches"]["full_participation"]["ota_round_step"]
          == 2 * FULL_ROUNDS, f"full participation K1 {rep['launches']}")
    check(cnt["ota_round_step"] == 2 * POP_ROUNDS + 2 * FULL_ROUNDS
          and cnt["plain_round_step"] == 0 and cnt["ota_aggregate"] == 0,
          f"population phase counts {cnt}")
    check(len(res.designs) == POP_ROUNDS // POP_COHORT_ROUNDS,
          f"one cohort redesign per tick: {[t for t, _ in res.designs]}")

    want = np.asarray(ref["redesigns"]["0/0"]["gamma"])
    err = _rel(np, res.designs[0][1][0, 0], want)
    print(f"  (c) the tick-0 cohort redesign (host f64 solver) against the "
          f"reference's: {err:.3e} relative in gamma (tol {REDESIGN_RTOL})",
          flush=True)
    check(err <= REDESIGN_RTOL, f"tick-0 cohort redesign off by {err:.3e}")

    t0 = time.time()
    r = REENTRY
    dep, prm, td = fig2.build_world(task, 0, num_devices=r["cohort"])
    prm = prm.replace(eta=task.eta_for("sca", float(prm.eta)))
    sca = pcm.make_sca(dep, prm, method="scipy")
    gm = scn.Population(spec=scn.PopulationSpec(
        size=r["size"], shadowing=scn.ShadowingSpec(),
        dynamics=scn.DynamicsSpec(rho=r["rho"])))
    run = task.run_config(num_rounds=r["rounds"], eval_every=r["every"],
                          seed=0, batch_size=BATCH)
    kw = dict(task_data=td, flat=True, device=dev, population=gm,
              cohort_size=r["cohort"], cohort_rounds=r["cohort_rounds"])
    launched = {}
    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        for label, extra in (
                ("whole", dict(checkpoint_path=str(Path(tmp) / "whole"))),
                ("first", dict(checkpoint_path=str(Path(tmp) / "fleet"),
                               max_chunks=r["max_chunks"])),
                ("resumed", dict(checkpoint_path=str(Path(tmp) / "fleet"),
                                 resume=True))):
            zero_counts()
            runs[label] = run_fleet_task(task, [sca], dep.gains, run, **kw,
                                         **extra)
            torch.cuda.synchronize()
            launched[label] = counts()["ota_round_step"]
        a = ckpt.load_flat(str(Path(tmp) / "whole"))
        b = ckpt.load_flat(str(Path(tmp) / "fleet"))
    whole, first, rest = runs["whole"], runs["first"], runs["resumed"]
    executed = {k: sum(n for n, _ in v.chunk_walls) for k, v in runs.items()}
    slots = sum(i.size for _, i in whole.cohorts)
    distinct = len(np.unique(np.concatenate([i[0] for _, i in
                                             whole.cohorts])))
    bitwise = {"params_traces": ss.bitwise(whole, rest),
               "evals": len(whole.evals) == len(rest.evals) and all(
                   np.array_equal(x[k], y[k]) for (_, x), (_, y)
                   in zip(whole.evals, rest.evals) for k in x),
               "fading_state": torch.equal(whole.fading_state,
                                           rest.fading_state),
               "cohorts": np.array_equal(a["cohorts_idx"], b["cohorts_idx"]),
               "pop_last": np.array_equal(a["pop_last"], b["pop_last"]),
               "pop_state": np.array_equal(a["pop_state"], b["pop_state"])}
    print(f"  (e) re-entry: a {r['size']}-device Gauss-Markov population "
          f"(rho {r['rho']}), cohort {r['cohort']}, cohort_rounds "
          f"{r['cohort_rounds']}, {r['rounds']} rounds, sca: "
          f"{len(whole.cohorts)} cohorts, {slots} cohort slots over "
          f"{distinct} distinct devices -- {slots - distinct} re-entries; "
          f"stopped after {r['max_chunks']} chunks and resumed: rounds run "
          f"{executed}, K1 launches {launched}; bitwise "
          f"{json.dumps(bitwise)}; {time.time() - t0:.2f} s", flush=True)
    check(slots > distinct, "no device re-entered")
    check(executed["first"] < r["rounds"] and executed["first"]
          + executed["resumed"] == r["rounds"] and launched == executed,
          f"rounds run {executed}, K1 launches {launched}")
    check(all(bitwise.values()), f"resumed population run differs: "
          f"{bitwise}")
    k1 = k1_row(torch, dev, card, (1, POP_COHORT, MAIN[2]),
                "the cohort fleet's", 10)
    walls = {"phase_s": time.time() - t_phase, **rep["wall_s"],
             "round_ms": rep["round_ms"],
             "overlap_saving_s": rep["overlap_saving_s"],
             "stage_chunks_s": rep["stage_chunks_s"]}
    print(f"  phase 10 walls [{card_line}]: {json.dumps(walls)}", flush=True)
    return {"k1_launches": rep["launches"]["stream"]["ota_round_step"],
            "k1_row": k1, "walls": walls}


def cifar_world(torch, np, dev):
    """cifar_conv's world (``fig2.build_world``, data seed 0) and its seven
    schemes designed at the task's step sizes, ``sca`` on the card (timed)
    and held against the reference's committed design."""
    from repro_torch import fig2
    from repro_torch.core import theory
    task = fig2._task("cifar_conv")
    dep, prm, td = fig2.build_world(task, 0)
    check(task.param_dim == CIFAR[2], f"cifar_conv d {task.param_dim}")
    torch.cuda.synchronize()
    t0 = time.time()
    schemes = fig2.make_schemes(task, dep, prm, device=dev)
    torch.cuda.synchronize()
    design_s = time.time() - t0
    with open(ROOT / "experiments" / "cifar_reference"
              / "sca_design.json") as f:
        want = json.load(f)
    prm_sca = prm.replace(eta=task.eta_for("sca", float(prm.eta)))
    check(int(want["d"]) == CIFAR[2] and float(want["eta"]) == prm_sca.eta,
          "the reference's cifar design is for another world")
    sca = schemes[fig2.SCHEMES.index("sca")]
    errs = {"gamma": _rel(np, sca.gamma, want["gamma"]),
            "alpha": _rel(np, sca.alpha, want["alpha"]),
            "thresholds": _rel(np, sca.thresholds, want["thresholds"]),
            "objective": _rel(np, theory.p1_objective(sca.gamma, prm_sca),
                              want["objective"])}
    print(f"  (a) cifar_conv world: d = {task.param_dim}, shards "
          f"{tuple(td.train[0].shape)} (Dirichlet 0.3, padded); the seven "
          f"schemes designed in {design_s:.3f} s (sca: the torch f64 "
          f"solver on the card); sca against the reference's committed "
          f"design, relative: {json.dumps(errs)} (tol {SCA_RTOL}, "
          f"objective {SCA_OBJECTIVE_RTOL})", flush=True)
    for name in ("gamma", "alpha", "thresholds"):
        check(errs[name] <= SCA_RTOL, f"cifar sca {name} off the "
              f"reference's by {errs[name]:.3e}")
    check(errs["objective"] <= SCA_OBJECTIVE_RTOL, "cifar sca objective off "
          f"the reference's by {errs['objective']:.3e}")
    return {"task": task, "dep": dep, "prm": prm, "td": td,
            "schemes": schemes, "design_s": design_s, "design_err": errs}


def cifar_curves(torch, np, dev, cw):
    """The cifar curves through K1 (150 rounds, an eval every 10, minibatch
    32) held by ``curves.gate`` against the reference's, at seeds 0-3, or
    0-7 where the gate's false-alarm rate at four seeds a side is over
    CIFAR_FALSE_ALARM_MAX."""
    from repro_torch import curves, scenario_sweep as ss
    reference, _ = curves.TASKS["cifar_conv"]
    rates = {n: ss.gate_false_alarm(curves.load_reference(
        CIFAR_PROTOCOL, range(n), reference), n)["any"] for n in (4, 8)}
    seeds = tuple(range(8 if rates[4] > CIFAR_FALSE_ALARM_MAX else 4))
    print(f"  (b) the gate's false-alarm rate over 21 comparisons at 4 "
          f"seeds a side {rates[4]:.4f}, at 8 {rates[8]:.4f}: seeds "
          f"{list(seeds)}", flush=True)
    runs = []

    def after(seed, res):
        torch.cuda.synchronize()
        runs.append((seed, _ota_counts(), round_ms(res), res.wall))
        zero_counts()
        check_result(torch, np, res, curves.ROUNDS, f"cifar seed {seed}")
    zero_counts()
    port = curves.run_port(CIFAR_PROTOCOL, seeds, dev, cw["schemes"],
                           after_run=after, task="cifar_conv")
    for seed, cnt, ms, wall in runs:
        print(f"  cifar seed {seed}: {curves.ROUNDS} rounds, round wall "
              f"{ms:.3f} ms, run wall {wall:.2f} s, counts {cnt}",
              flush=True)
        check(cnt == {"ota_round_step": curves.ROUNDS, "ota_aggregate": 0,
                      "plain_round_step": 0, "plain_aggregate": 0},
              f"cifar seed {seed}: K1 must launch once a round and nothing "
              f"else of the OTA tail run: {cnt}")
    rows = curves.gate(port, curves.load_reference(CIFAR_PROTOCOL, seeds,
                                                   reference))
    print(curves.table(rows, f"  cifar_conv {CIFAR_PROTOCOL}: port (this "
                       f"card) vs reference (CPU), seeds {list(seeds)}, "
                       f"{curves.ROUNDS} rounds"), flush=True)
    fails = [f"{r['scheme']}/{r['stat']}" for r in rows if not r["ok"]]
    check(not fails, f"cifar curves outside the gate: {fails}")
    return {"seeds": list(seeds), "false_alarm": rates,
            "round_ms": [ms for _, _, ms, _ in runs],
            "gate_ok": f"{len(rows)}/{len(rows)}"}


def _same_run(np, torch, a, b, bv=True):
    """Params, traces (the ``bv_*`` ones only when ``bv``) and evals of two
    fleet results, bitwise."""
    keys = [k for k in a.traces if bv or not k.startswith("bv_")]
    return (all(torch.equal(a.params[k], b.params[k]) for k in a.params)
            and all(k in b.traces and np.array_equal(a.traces[k],
                                                     b.traces[k])
                    for k in keys)
            and [t for t, _ in a.evals] == [t for t, _ in b.evals]
            and all(np.array_equal(x[k], y[k]) for (_, x), (_, y)
                    in zip(a.evals, b.evals) for k in x))


def cifar_telemetry(torch, np, dev, cw):
    """``fig2.run(task="cifar_conv", telemetry=True)`` (the path of ``fig2
    --task cifar_conv --telemetry``) for TEL_ROUNDS rounds with a
    checkpoint, against the same run with telemetry off; its report; and
    its kill and resume under telemetry."""
    import os
    import subprocess as sp
    import tempfile
    from repro_torch import fig2
    from repro_torch.telemetry import read_events
    kw = dict(num_rounds=TEL_ROUNDS, eval_every=EVERY, seed=0,
              batch_size=CIFAR_BATCH, task=cw["task"], save=False,
              designs=cw["schemes"], device=dev)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        zero_counts()
        _, off = fig2.run(**kw, checkpoint_path=str(tmp / "off" / "fleet"))
        torch.cuda.synchronize()
        cnt_off = counts()
        zero_counts()
        _, on = fig2.run(**kw, telemetry=True, out_dir=tmp / "on",
                         checkpoint_path=str(tmp / "on" / "fleet"))
        torch.cuda.synchronize()
        cnt_on = counts()
        events = read_events(str(tmp / "on"))
        execs = [e["chunk"] for e in events if e["ev"] == "chunk_exec"]
        proc = sp.run([sys.executable, "-m", "repro_torch.telemetry.report",
                       str(tmp / "on")], capture_output=True, text=True,
                      timeout=300, env={**os.environ,
                                        "PYTHONPATH": str(SRC)})
        report_ok = proc.returncode == 0 and all(
            t in proc.stdout for t in REPORT_SECTIONS) \
            and "bv_bias_power" in proc.stdout
        first = fig2.run(**kw, telemetry=True, out_dir=tmp / "kill",
                         checkpoint_path=str(tmp / "kill" / "fleet"),
                         max_chunks=1)[1]
        rest = fig2.run(**kw, telemetry=True, out_dir=tmp / "kill",
                        checkpoint_path=str(tmp / "kill" / "fleet"),
                        resume=True)[1]
        kill_ev = read_events(str(tmp / "kill"))
    kill_execs = [e["chunk"] for e in kill_ev if e["ev"] == "chunk_exec"]
    same = _same_run(np, torch, on, off, bv=False)
    bv = sorted(k for k in on.traces if k.startswith("bv_"))
    resumed = _same_run(np, torch, on, rest)
    out = {"round_ms_off": round_ms(off), "round_ms_on": round_ms(on),
           "k1_launches": cnt_on["ota_round_step"]}
    out["overhead_share"] = out["round_ms_on"] / out["round_ms_off"] - 1.0
    print(f"  (c) fig2.run cifar_conv --telemetry, {TEL_ROUNDS} rounds with "
          f"a checkpoint: params, the non-bv traces and the evals bitwise "
          f"telemetry off: {same}; bv traces {bv}; {len(events)} events, "
          f"chunk_exec of chunks {execs} ({len(on.chunk_walls)} chunks); "
          f"round wall {out['round_ms_off']:.3f} ms off, "
          f"{out['round_ms_on']:.3f} ms on ({100 * out['overhead_share']:+.1f}"
          f" %); counts off {cnt_off}, on {cnt_on}; report exit "
          f"{proc.returncode}, every section: {report_ok}", flush=True)
    print("\n".join("    | " + line for line in proc.stdout.splitlines()
                    [:40]), flush=True)
    check(same, "telemetry on changed params, traces or evals")
    check(bv == ["bv_bias_power", "bv_chan_power", "bv_noise_var",
                 "bv_weight_dev"] and not any(k.startswith("bv_")
                                              for k in off.traces),
          f"bv traces: on {bv}, off {sorted(off.traces)}")
    check(execs == list(range(len(on.chunk_walls))),
          f"one chunk_exec per chunk: {execs}")
    check(cnt_on["ota_round_step"] == cnt_off["ota_round_step"] == TEL_ROUNDS
          and cnt_on["plain_round_step"] == 0,
          f"K1 once a round with and without telemetry: {cnt_off}, "
          f"{cnt_on}")
    check(report_ok, f"telemetry.report: {proc.returncode} "
          f"{proc.stderr[-2000:]}")
    runs = {e["run"] for e in kill_ev}
    print(f"  (d) kill after chunk 1 and resume under telemetry: bitwise the "
          f"uninterrupted run (bv traces included): {resumed}; run ids "
          f"{sorted(runs)}; chunk_exec of chunks {kill_execs}; "
          f"{sum(e['ev'] == 'run_resume' for e in kill_ev)} run_resume",
          flush=True)
    check(sum(n for n, _ in first.chunk_walls) < TEL_ROUNDS,
          "the first invocation ran every round")
    check(resumed, "the resumed run differs from the uninterrupted one")
    check(len(runs) == 1 and kill_execs == list(range(len(on.chunk_walls))),
          f"one log after kill and resume: runs {runs}, chunks {kill_execs}")
    return out


def cifar_forced_off(torch, dev, cw):
    """K1 (SHORT fused rounds) and K2 (SHORT unfused rounds) forced off vs
    on, the cifar fleet, bitwise."""
    from repro_torch.fl.driver import run_fleet_task
    task, dep, td = cw["task"], cw["dep"], cw["td"]
    run = task.run_config(num_rounds=SHORT, eval_every=SHORT, seed=0,
                          batch_size=CIFAR_BATCH)
    out = {}
    for label, kw, kernel in (("fused", {}, "ota_round_step"),
                              ("unfused", {"fuse_round": False},
                               "ota_aggregate")):
        zero_counts()
        on = run_fleet_task(task, cw["schemes"], dep.gains, run,
                            task_data=td, flat=True, device=dev, **kw)
        torch.cuda.synchronize()
        cnt = _ota_counts()
        off = run_fleet_task(task, cw["schemes"], dep.gains, run,
                             task_data=td, flat=True, device=dev,
                             use_kernel=False, **kw)
        same = all(torch.equal(on.params[k], off.params[k])
                   for k in on.params)
        print(f"  (e) cifar {label}, {SHORT} rounds, {kernel} forced off vs "
              f"on: bitwise {same}; counts on {cnt}", flush=True)
        check(cnt[kernel] == SHORT and sum(cnt.values()) == SHORT,
              f"cifar {label}: {kernel} once a round, nothing else: {cnt}")
        check(same, f"cifar {label}: kernels forced off differ")
        out[label] = cnt[kernel]
    return out


def population_telemetry(torch, np, dev, world):
    """A short ``adaptive_sca`` population run under telemetry, stream on:
    the phase-10 world (1M devices, disk, 8 dB shadowing, traffic-weighted
    cohorts of 50, paper_mlp) made Gauss-Markov, two cohorts."""
    import tempfile
    from repro_torch import fig2
    from repro_torch.core import power_control as pcm, scenarios as scn
    from repro_torch.fl.driver import run_fleet_task
    from repro_torch.telemetry import Telemetry, read_events
    task = world["task"]
    p = POP_TEL
    dep, prm, td = fig2.build_world(task, 0, num_devices=POP_COHORT)
    prm = prm.replace(eta=task.eta_for("adaptive_sca", float(prm.eta)))
    pcs = [pcm.make_adaptive_sca(dep, prm, base=pcm.make_sca(
        dep, prm, method="scipy"))]
    pop = scn.Population(spec=scn.PopulationSpec(
        size=POP_SIZE, shadowing=scn.ShadowingSpec(), sampling="traffic",
        dynamics=scn.DynamicsSpec(rho=p["rho"])))
    run = task.run_config(num_rounds=p["rounds"], eval_every=p["every"],
                          seed=0, batch_size=BATCH)
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        zero_counts()
        res = run_fleet_task(task, pcs, dep.gains, run, task_data=td,
                             flat=True, population=pop,
                             cohort_size=POP_COHORT,
                             cohort_rounds=p["cohort_rounds"], stream=True,
                             telemetry=Telemetry(run_dir=tmp,
                                                 kappa_sq=float(prm.kappa_sq)),
                             device=dev)
        torch.cuda.synchronize()
        cnt = _ota_counts()
        events = read_events(tmp)
    kinds = {}
    for e in events:
        kinds[e["ev"]] = kinds.get(e["ev"], 0) + 1
    solves = [e for e in events if e["ev"] == "sca_solve"]
    cohorts = [e for e in events if e["ev"] == "cohort"]
    stages = [e for e in events if e["ev"] == "stage"]
    waits = [e for e in events if e["ev"] == "stage_wait"]
    stale = [np.asarray(e["staleness"]).shape for e in cohorts
             if "staleness" in e]
    print(f"  (f) population under telemetry: adaptive_sca on "
          f"{POP_SIZE:,} Gauss-Markov devices (rho {p['rho']}), cohort "
          f"{POP_COHORT}, {p['rounds']} rounds, a cohort every "
          f"{p['cohort_rounds']}, stream on: events {json.dumps(kinds)}; "
          f"sca_solve chunks {[e.get('chunk') for e in solves]}; cohort "
          f"staleness shapes {stale}, never seen "
          f"{[e.get('never_seen') for e in cohorts]}; stage chunks "
          f"{[e['chunk'] for e in stages]}, stage_wait chunks "
          f"{[e['chunk'] for e in waits]}; counts {cnt}; "
          f"{time.time() - t0:.2f} s", flush=True)
    check(len(solves) == len(cohorts) == 2 and all(
        isinstance(e.get("chunk"), int) for e in solves),
        "one sca_solve per fresh cohort, tagged with its chunk")
    check(len(stale) == len(cohorts) and all(
        sh == (1, POP_COHORT) for sh in stale), "cohorts carry staleness")
    check(stages and waits and len(waits) == len(stages) - 1,
          "stage and stage_wait events")
    check(cnt["ota_round_step"] == p["rounds"]
          and cnt["plain_round_step"] == 0, f"population K1 {cnt}")
    check(len(res.designs) == 2, "two cohort redesigns")
    return kinds


def phase_cifar(torch, np, dev, card, card_line, world):
    """Phase 11: the cifar_conv fleet with run telemetry at full width."""
    from repro_torch import fig2
    from repro_torch.profile_round import fig2_fleet, profile
    t_phase = time.time()
    cw = cifar_world(torch, np, dev)
    curves_stats = cifar_curves(torch, np, dev, cw)
    tel = cifar_telemetry(torch, np, dev, cw)
    forced = cifar_forced_off(torch, dev, cw)
    k1 = k1_row(torch, dev, card, CIFAR, "the cifar fleet's", 12)
    pop = population_telemetry(torch, np, dev, world)
    fleet, _, _, grad_ms = fig2_fleet(cw["task"], SHORT, CIFAR_BATCH, dev,
                                      schemes=cw["schemes"])
    prof = profile(fleet, SHORT)
    det, dflt = grad_ms["deterministic_True"], grad_ms["deterministic_False"]
    print(f"  (g) the cifar round, telemetry off, {SHORT} rounds under "
          f"torch.profiler: {prof['launches_per_round']:.1f} kernel "
          f"launches a round, device {prof['device_ms_per_round']:.3f} ms, "
          f"wall {prof['round_wall_ms']:.3f} ms, busy "
          f"{prof['busy_share']:.3f}; two runs apart by "
          f"{prof['repeat_max_abs_diff']:.3e} (deterministic cuDNN); top "
          f"kernels {json.dumps(prof['top'][:6])} [{card_line}]",
          flush=True)
    print(f"  (g) the round's gradients alone (CUDA events): "
          f"{det['ms']:.3f} ms with deterministic cuDNN, {dflt['ms']:.3f} "
          f"ms with cuDNN's default algorithms "
          f"({100 * (det['ms'] / dflt['ms'] - 1):+.1f} %); two calls apart "
          f"by {det['repeat_max_abs_diff']:.3e} and "
          f"{dflt['repeat_max_abs_diff']:.3e}", flush=True)
    check(prof["repeat_max_abs_diff"] == 0.0
          and det["repeat_max_abs_diff"] == 0.0,
          "two runs of the same cifar fleet differ")
    walls = {"phase_s": time.time() - t_phase, "design_s": cw["design_s"],
             "curves": curves_stats, "telemetry": tel,
             "launches_per_round": prof["launches_per_round"],
             "gradients_ms": grad_ms,
             "device_ms_per_round": prof["device_ms_per_round"],
             "busy_share": prof["busy_share"]}
    print(f"  phase 11 walls [{card_line}]: {json.dumps(walls)}", flush=True)
    return {"k1_launches": tel["k1_launches"], "k1_row": k1,
            "forced": forced, "walls": walls, "events": pop}


def _ota_counts():
    return {k: v for k, v in counts().items()
            if k in ("ota_round_step", "ota_aggregate", "plain_round_step",
                     "plain_aggregate")}


def phase_scenarios(torch, np, dev, card, card_line):
    """Phase 8: the heterogeneous-wireless path -- the theory sweep over
    every registered scenario, the full-width grid through K1 and its
    identities, K1/K2 forced off, the adaptive scheme's redesigns, and
    kill and resume on a Gauss-Markov fleet and on the grid."""
    import dataclasses
    import tempfile
    from repro_torch import curves, scenario_sweep as ss, tasks
    from repro_torch.core import power_control as pcm, scenarios as scn
    from repro_torch.fl.driver import run_fleet_task
    from repro_torch.fl.engine import chunk_lengths
    walls = {}
    t_phase = time.time()
    world = ss.design(scn.scenario_names(), device=dev)
    walls["sca_designs_s"] = {fam: sec for fam, _, sec in world["sca_calls"]}
    for fam, group, sec in world["sca_calls"]:
        print(f"  sca designs, {fam} ({', '.join(group)}): one batched solve "
              f"on the card, {sec:.3f} s [{card_line}]", flush=True)
    ref = ss.load_theory_reference(0)
    errs = ss.theory_errors(ss.sweep(world), ref)
    worst = max(errs, key=errs.get)
    design_err = {n: _rel(np, world[n]["schemes"][0].gamma,
                          ref["sca_designs"][n]["gamma"])
                  for n in scn.SWEEP_FAMILIES}
    print(f"  theory rows of {len(errs)} (scenario, scheme) pairs: largest "
          f"relative error of bias / variance / objective {errs[worst]:.3e} "
          f"({worst}; tol {THEORY_RTOL}); the grid's sca designs against "
          f"the reference's per-scenario designs {json.dumps(design_err)}",
          flush=True)
    check(len(errs) == 30 and errs[worst] <= THEORY_RTOL,
          f"theory rows off the reference's: {worst} {errs[worst]:.3e}")
    check(max(design_err.values()) <= THEORY_RTOL,
          f"grid sca designs off the reference's: {design_err}")
    walls["theory_s"] = time.time() - t_phase

    task = tasks.get("paper_mlp", expect_runtime="fleet")
    check(ss.run_config(task, ss.ROUNDS, ss.EVERY).batch_size == 0,
          "the grid runs paper_mlp's full batch")
    rep = ss.grid(world, task, device=dev)
    res, checks = rep["result"], ss.grid_ok(rep)
    grid_counts = rep["counts"]["grid"]
    walls.update(rep["walls"], grid_round_ms=round_ms(res),
                 grid_more_seeds_round_ms=round_ms(rep["more"]))
    k_total = len(res.names)
    check(k_total * len(res.seeds) == GRID_CELLS
          and res.params["w1"].shape[:2] == (k_total, len(ss.SEEDS)),
          f"grid cells {k_total} x {len(res.seeds)}")
    check(all(bool(torch.isfinite(v).all()) for v in res.params.values()),
          "grid params not finite")
    more = rep["more"].seeds
    print(f"  grid {len(scn.SWEEP_FAMILIES)} x {len(ss.SCHEMES)} x "
          f"{len(ss.SEEDS)} = {GRID_CELLS} cells, d = {task.param_dim}, full "
          f"batch, fused f32 tail, {ss.ROUNDS} rounds: counts "
          f"{grid_counts}, round wall {walls['grid_round_ms']:.3f} ms, run "
          f"wall {res.wall:.2f} s; the gate's other seeds {list(more)}: a "
          f"second 48-cell grid, round wall "
          f"{walls['grid_more_seeds_round_ms']:.3f} ms [{card_line}]",
          flush=True)
    print(curves.table(rep["gate"], f"  grid: port (this card) vs reference "
                       f"(CPU), seeds {list(res.seeds + more)}, {ss.ROUNDS} "
                       "rounds"), flush=True)
    print(f"  bitwise: R = 1 grid vs the disk_rayleigh fleet, the grid vs "
          f"its 4 scenario fleets, {ss.IDENTITY_ROUNDS} grid rounds with K1 "
          f"forced off vs on, {ss.UNFUSED_ROUNDS} unfused rounds with K2 off "
          f"vs on (K2 counts {rep['counts']['unfused']}): "
          f"{json.dumps(rep['identities'])}", flush=True)
    check(checks["grid_launches"],
          f"the grid must launch K1 once a round: {grid_counts}")
    misses = [f"{r['scheme']}/{r['stat']}" for r in rep["gate"]
              if not r["ok"]]
    check(checks["gate"], f"grid curves outside the gate: {misses}")
    check(checks["identities"], f"a grid identity failed: "
          f"{rep['identities']}")
    check(checks["unfused_launches"], f"the unfused grid must launch K2 "
          f"once a round: {rep['counts']['unfused']}")
    td = task.build_data(0)
    base = dict(task_data=td, params=task.init_params(0, dev),
                eval_fn=task.make_eval(td, dev), device=dev)
    k1_row = k1_value_patterns(torch, dev, card)

    t0 = time.time()
    mk = world["disk_markov"]
    fading = scn.make_fading_process(mk["dep"], mk["scenario"].dynamics)
    redesign_s = []
    pc = pcm.make_adaptive_sca(mk["dep"], mk["prm"],
                               base=mk["schemes"][0], device=dev)
    hook = pc.redesign_fn

    def timed(scheme, proc, state):
        torch.cuda.synchronize()
        ts = time.time()
        out = hook(scheme, proc, state)
        torch.cuda.synchronize()
        redesign_s.append(time.time() - ts)
        return out
    pc = dataclasses.replace(pc, redesign_fn=timed)
    arun = ss.run_config(task, ADAPTIVE_ROUNDS, ADAPTIVE_EVERY)
    zero_counts()
    ares = run_fleet_task(task, [pc], mk["dep"].gains, arun, etas=[ss.ETA],
                          seeds=ss.SEEDS, fading=fading, flat=True, **base)
    torch.cuda.synchronize()
    a_counts = _ota_counts()
    gam = [g for _, g in ares.designs]
    moves = [_rel(np, b, a) for a, b in zip(gam, gam[1:])]
    seed_spread = [float(np.max(np.abs(g[0] - g[0, :1]) / np.abs(g[0, :1])))
                   for g in gam[1:]]
    state = ares.fading_state[0].expand((1,) + tuple(
        ares.fading_state.shape[1:]))
    ts = time.time()
    on_card = hook(pc, fading, state)
    torch.cuda.synchronize()
    card_s = time.time() - ts
    ts = time.time()
    on_cpu = hook(pc, fading, state.cpu())
    cpu_s = time.time() - ts
    cpu_err = {f: _rel(np, getattr(on_card, f), getattr(on_cpu, f))
               for f in ("gamma", "alpha")}
    walls.update(adaptive_s=time.time() - t0,
                 adaptive_round_ms=round_ms(ares), redesign_s=redesign_s,
                 final_redesign_card_s=card_s, final_redesign_cpu_s=cpu_s)
    print(f"  adaptive_sca on disk_markov, {ADAPTIVE_ROUNDS} rounds, "
          f"S = {len(ss.SEEDS)}: designs at rounds "
          f"{[t for t, _ in ares.designs]}, moves between chunks "
          f"{moves}, spread across seeds {seed_spread}; redesign walls "
          f"{[round(x, 3) for x in redesign_s]} s; round wall "
          f"{walls['adaptive_round_ms']:.3f} ms; counts {a_counts}; the final "
          f"state's redesign on the card {card_s:.3f} s vs this machine's CPU "
          f"{cpu_s:.3f} s, relative difference {json.dumps(cpu_err)} "
          f"[{card_line}]", flush=True)
    # a redesign at every chunk boundary before the last round: the
    # reference's cadence ends chunks after rounds 0, 10, 20 and 29
    n_redesigns = len(chunk_lengths(ADAPTIVE_ROUNDS, ADAPTIVE_EVERY, True)) - 1
    check(len(ares.designs) == n_redesigns + 1
          and len(redesign_s) == n_redesigns,
          f"adaptive designs {[t for t, _ in ares.designs]}")
    check(min(moves) > ADAPTIVE_MOVE and min(seed_spread) > ADAPTIVE_MOVE,
          f"adaptive designs did not move: {moves}, {seed_spread}")
    check(max(cpu_err.values()) <= THEORY_RTOL,
          f"redesign on the card vs the CPU: {cpu_err}")
    check(a_counts["ota_round_step"] == ADAPTIVE_ROUNDS,
          f"adaptive fleet K1 counts {a_counts}")

    t0 = time.time()
    resumes = {}
    rrun = ss.run_config(task, RESUME_ROUNDS, EVERY)
    for label, fleet in (
            ("disk_markov", lambda **kw: ss.scenario_fleet(
                task, world, "disk_markov", rrun, ss.SEEDS, **kw)),
            ("grid", lambda **kw: ss.grid_fleet(
                task, world, scn.SWEEP_FAMILIES, rrun, ss.SEEDS, **kw))):
        whole = fleet(**base)
        with tempfile.TemporaryDirectory() as tmp:
            path = str(Path(tmp) / "fleet")
            first = fleet(checkpoint_path=path, max_chunks=1, **base)
            rest = fleet(checkpoint_path=path, resume=True, **base)
        done = (sum(n for n, _ in first.chunk_walls),
                sum(n for n, _ in rest.chunk_walls))
        same = {"params_traces": ss.bitwise(rest, whole),
                "evals": all(np.array_equal(a[k], b[k])
                             for (_, a), (_, b) in zip(whole.evals,
                                                       rest.evals)
                             for k in a)
                and len(whole.evals) == len(rest.evals),
                "fading_state": torch.equal(whole.fading_state,
                                            rest.fading_state)}
        resumes[label] = same
        print(f"  kill and resume, {label}: {RESUME_ROUNDS} rounds, rounds "
              f"run {done}; bitwise {json.dumps(same)}", flush=True)
        check(done[0] < RESUME_ROUNDS and sum(done) == RESUME_ROUNDS
              and all(same.values()), f"{label} resume: {done} {same}")
    walls["resume_s"] = time.time() - t0
    walls["phase_s"] = time.time() - t_phase
    print(f"  phase 8 walls [{card_line}]: {json.dumps(walls)}", flush=True)
    return {"grid_k1": grid_counts["ota_round_step"], "k1_row": k1_row,
            "walls": walls}


def attention_on_vs_off(torch, res, cfg):
    """K3 on vs forced off on a serve run's weights and prompts: the first
    layer's attention output (on, off), and the prefill logits of K3
    against its plain version as (max |d|, max |logit|, share of equal
    greedy tokens)."""
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import embed, rmsnorm
    p0 = res.params["layers"][0]
    with torch.no_grad():
        h = rmsnorm(p0["ln1"], embed(res.params["embed"], res.prompts,
                                     cfg.compute_dtype), cfg.norm_eps)
        on, _ = attn.gqa_apply(p0["mixer"], h, cfg)
        off, _ = attn.gqa_apply(p0["mixer"], h, cfg, use_kernel=False)
        logits_off, _ = tfm.forward(res.params, res.prompts, cfg,
                                    use_kernel=False)
    kernel = (float((res.logits - logits_off).abs().max()),
              float(logits_off.abs().max()),
              float((res.logits.argmax(-1) == logits_off.argmax(-1))
                    .float().mean()))
    return on.float(), off.float(), kernel


def check_serve_run(torch, res, cnt, label):
    """One qwen serve run: K3 once per layer in each of its two prefills
    (warm-up, timed), no plain attention, OTA kernel or K4; finite logits
    and tokens in range."""
    n_layers = res.cfg.n_layers
    check(res.stats["k3_launches_per_prefill"] == n_layers,
          f"{label}: K3 launched {res.stats['k3_launches_per_prefill']} "
          f"times in a prefill of {n_layers} layers")
    check(cnt["flash_attention"] == 2 * n_layers,     # warm-up + timed
          f"{label}: K3 launched {cnt['flash_attention']} times in 2 "
          "prefills")
    check(cnt["plain_attention"] == 0,
          f"{label}: K3's plain version ran on the card")
    check(cnt["ota_round_step"] == cnt["ota_aggregate"] == 0,
          f"{label}: an OTA kernel ran on the serve path")
    check(cnt["ssd_scan"] == cnt["plain_ssd"] == 0,
          f"{label}: K4 or its plain version ran on the GQA serve path")
    b, s, v = SERVE["batch"], SERVE["prompt_len"], res.cfg.padded_vocab
    check(tuple(res.logits.shape) == (b, s, v),
          f"{label}: logits {res.logits.shape}")
    check(bool(torch.isfinite(res.logits).all()), f"{label}: logits not "
          "finite")
    check(tuple(res.tokens.shape) == (b, SERVE["decode_tokens"]),
          f"{label}: tokens {res.tokens.shape}")
    check(int(res.tokens.min()) >= 0 and int(res.tokens.max()) < v,
          f"{label}: a token out of range")


def phase_serve(torch, dev):
    """Phase 5: the LM serve path at full width, K3 on vs forced off, in
    bf16 and in float32, and a sliding-window run through the ring
    cache."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    argv = [f"--{k.replace('_', '-')}={v}" for k, v in SERVE.items()]
    zero_counts()
    res = serve.main(argv)
    torch.cuda.synchronize()
    main_cnt = counts()
    cfg, st = res.cfg, res.stats
    print(f"  serve main path: counts {main_cnt}", flush=True)
    check_serve_run(torch, res, main_cnt, "bf16 serve")
    b, s = SERVE["batch"], SERVE["prompt_len"]

    # K3 forced off, same weights and prompts
    on, off, kernel = attention_on_vs_off(torch, res, cfg)
    layer0_err = float((on - off).abs().max())
    drift = {"bf16": {"layer0_attention_max_abs_err": layer0_err,
                      "logits_max_abs_diff": kernel[0],
                      "logits_max_abs": kernel[1],
                      "equal_next_tokens": kernel[2]}}
    print(f"  serve (bf16), K3 on vs off: {json.dumps(drift['bf16'])} "
          f"(tolerance: layer 0 within {ATTN_BF16_TOL}; logits within "
          f"{DRIFT_LOGITS_SHARE} of max |logit|, greedy tokens equal at >= "
          f"{EQUAL_TOKENS_MIN} of positions)", flush=True)
    check(bool((on - off).abs().le(ATTN_BF16_TOL["atol"]
                                   + ATTN_BF16_TOL["rtol"]
                                   * off.abs()).all()),
          f"layer 0 attention, K3 on vs off: max |d| {layer0_err}")
    check(kernel[0] <= DRIFT_LOGITS_SHARE * kernel[1],
          f"logits drift {kernel[0]} over {DRIFT_LOGITS_SHARE} x {kernel[1]}")
    check(kernel[2] >= EQUAL_TOKENS_MIN, f"equal next tokens {kernel[2]}")
    del res, on, off

    # the same model in float32 (the same draw, unrounded): K3's f32 kernel
    # in every prefill
    cfg32 = cfg.replace(param_dtype=torch.float32,
                        compute_dtype=torch.float32)
    zero_counts()
    r32 = serve.run(cfg32, batch=b, prompt_len=s,
                    decode_tokens=SERVE["decode_tokens"], seed=0, device=dev)
    torch.cuda.synchronize()
    f32_cnt = counts()
    print(f"  serve (f32): counts {f32_cnt}", flush=True)
    check_serve_run(torch, r32, f32_cnt, "f32 serve")
    on, off, kernel = attention_on_vs_off(torch, r32, cfg32)
    layer0_err = float((on - off).abs().max())
    drift["f32"] = {"layer0_attention_max_abs_err": layer0_err,
                    "layer0_attention_max_abs": float(off.abs().max()),
                    "logits_max_abs_diff": kernel[0],
                    "logits_max_abs": kernel[1],
                    "equal_next_tokens": kernel[2],
                    "prefill_ms": r32.stats["prefill_ms"],
                    "decode_ms_per_token": r32.stats["decode_ms_per_token"]}
    print(f"  serve (f32), K3 on vs off: {json.dumps(drift['f32'])} "
          f"(tolerance: layer 0 within {F32_TOL}; logits within "
          f"{DRIFT_LOGITS_SHARE} of max |logit|, greedy tokens equal at >= "
          f"{EQUAL_TOKENS_MIN} of positions)", flush=True)
    check(bool((on - off).abs().le(F32_TOL["atol"]
                                   + F32_TOL["rtol"] * off.abs()).all()),
          f"f32 layer 0 attention, K3 on vs off: max |d| {layer0_err}")
    check(kernel[0] <= DRIFT_LOGITS_SHARE * kernel[1],
          f"f32 logits drift {kernel[0]} over {DRIFT_LOGITS_SHARE} x "
          f"{kernel[1]}")
    check(kernel[2] >= EQUAL_TOKENS_MIN, f"f32 equal next tokens {kernel[2]}")
    del r32, on, off

    # sliding window shorter than the prompt: ring-cache decode
    swa_cfg = configs.long_context_config(SERVE["arch"]).replace(**SWA)
    zero_counts()
    sw = serve.run(swa_cfg, batch=b, prompt_len=s,
                   decode_tokens=SERVE["decode_tokens"], seed=0, device=dev)
    torch.cuda.synchronize()
    cnt = counts()
    check(sw.stats["k3_launches_per_prefill"] == SWA["n_layers"],
          f"swa: K3 launched {sw.stats['k3_launches_per_prefill']} times")
    check(cnt["plain_attention"] == 0, "swa: K3's plain version ran")
    check(bool(torch.isfinite(sw.logits).all()), "swa: logits not finite")
    # the ring decode's greedy tokens against one windowed forward (K3)
    # over the prompt and the tokens fed back
    with torch.no_grad():
        seq = torch.cat([sw.prompts, sw.tokens[:, :-1]], dim=1)
        full, _ = tfm.forward(sw.params, seq, swa_cfg)
    want = full[:, s - 1:].argmax(-1)
    ring_equal = float((want == sw.tokens).float().mean())
    print(f"  swa (2 layers, window {SWA['window']}, ring cache of "
          f"{SWA['window']} slots): {json.dumps(sw.stats)}; greedy tokens "
          f"equal to a full windowed forward at {ring_equal}", flush=True)
    check(ring_equal >= EQUAL_TOKENS_MIN,
          f"swa: ring decode agrees with the full forward at {ring_equal}")
    return st, main_cnt, f32_cnt, drift, {"equal_tokens": ring_equal,
                                          **sw.stats}


def ssd_on_vs_off(torch, res, cfg):
    """K4 on vs forced off on a serve run's weights and prompts: the first
    layer's mixer output (on, off), and the prefill logits of K4 against
    its plain version as (max |d|, max |logit|, share of equal greedy
    tokens)."""
    from repro_torch.models import ssm
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import embed, rmsnorm
    p0 = res.params["layers"][0]
    with torch.no_grad():
        h = rmsnorm(p0["ln1"], embed(res.params["embed"], res.prompts,
                                     cfg.compute_dtype), cfg.norm_eps)
        on, _ = ssm.ssd_apply(p0["mixer"], h, cfg)
        off, _ = ssm.ssd_apply(p0["mixer"], h, cfg, use_kernel=False)
        logits_off, _ = tfm.forward(res.params, res.prompts, cfg,
                                    use_kernel=False)
    kernel = (float((res.logits - logits_off).abs().max()),
              float(logits_off.abs().max()),
              float((res.logits.argmax(-1) == logits_off.argmax(-1))
                    .float().mean()))
    return on.float(), off.float(), kernel


def ssd_state_check(torch, res, cfg):
    """Share of the greedy tokens of prefill + recurrent decode that one
    prefill (K4) over the prompt and the fed-back tokens reproduces."""
    from repro_torch.models import transformer as tfm
    with torch.no_grad():
        seq = torch.cat([res.prompts, res.tokens[:, :-1]], dim=1)
        full, _ = tfm.forward(res.params, seq, cfg)
    want = full[:, res.prompts.shape[1] - 1:].argmax(-1)
    return float((want == res.tokens).float().mean())


def phase_serve_ssd(torch, dev):
    """Phase 6: the Mamba-2 serve path at full width, K4 on vs forced off,
    prefill + recurrent decode against one prefill; then both checks on
    the same model in float32."""
    from repro_torch.launch import serve
    argv = [f"--{k.replace('_', '-')}={v}" for k, v in SSD_SERVE.items()]
    zero_counts()
    res = serve.main(argv)
    torch.cuda.synchronize()
    cnt = counts()
    cfg, st = res.cfg, res.stats
    n_layers = cfg.n_layers
    print(f"  mamba2 serve main path: counts {cnt}", flush=True)
    check(st["k4_launches_per_prefill"] == n_layers,
          f"K4 launched {st['k4_launches_per_prefill']} times in a prefill "
          f"of {n_layers} layers")
    check(cnt["ssd_scan"] == 2 * n_layers,            # warm-up + timed
          f"K4 launched {cnt['ssd_scan']} times in 2 prefills")
    check(cnt["plain_ssd"] == 0, "K4's plain version ran on the card")
    check(cnt["flash_attention"] == cnt["plain_attention"] == 0,
          "attention ran on the Mamba-2 path")
    check(cnt["ota_round_step"] == cnt["ota_aggregate"] == 0,
          "an OTA kernel ran on the serve path")
    b, s = SSD_SERVE["batch"], SSD_SERVE["prompt_len"]
    v = cfg.padded_vocab
    check(tuple(res.logits.shape) == (b, s, v), f"logits {res.logits.shape}")
    check(bool(torch.isfinite(res.logits).all()), "logits not finite")
    check(tuple(res.tokens.shape) == (b, SSD_SERVE["decode_tokens"]),
          f"tokens {res.tokens.shape}")
    check(int(res.tokens.min()) >= 0 and int(res.tokens.max()) < v,
          "a token out of range")

    # bf16, the main path's weights: K4 forced off
    on, off, kernel = ssd_on_vs_off(torch, res, cfg)
    layer0_err = float((on - off).abs().max())
    check(bool((on - off).abs().le(ATTN_BF16_TOL["atol"]
                                   + ATTN_BF16_TOL["rtol"]
                                   * off.abs()).all()),
          f"layer 0 mixer, K4 on vs off: max |d| {layer0_err}")
    drift = {"bf16": {
        "layer0_mixer_max_abs_err": layer0_err,
        "layer0_mixer_max_abs": float(off.abs().max()),
        "logits_max_abs_diff": kernel[0], "logits_max_abs": kernel[1],
        "equal_next_tokens": kernel[2],
        "state_equal_tokens": ssd_state_check(torch, res, cfg)}}
    print(f"  mamba2 serve (bf16), K4 on vs off and prefill + decode vs one "
          f"prefill: {json.dumps(drift['bf16'])} (tolerance: layer 0 within "
          f"{ATTN_BF16_TOL}; the whole model's numbers are readings, held "
          f"in f32 below)", flush=True)
    del res, on, off

    # the same model in float32 (the same draw, unrounded)
    cfg32 = cfg.replace(param_dtype=torch.float32,
                        compute_dtype=torch.float32)
    r32 = serve.run(cfg32, batch=b, prompt_len=s,
                    decode_tokens=SSD_SERVE["decode_tokens"], seed=0,
                    device=dev)
    on, off, kernel = ssd_on_vs_off(torch, r32, cfg32)
    layer0_err = float((on - off).abs().max())
    state_equal = ssd_state_check(torch, r32, cfg32)
    drift["f32"] = {
        "layer0_mixer_max_abs_err": layer0_err,
        "layer0_mixer_max_abs": float(off.abs().max()),
        "logits_max_abs_diff": kernel[0], "logits_max_abs": kernel[1],
        "equal_next_tokens": kernel[2],
        "state_equal_tokens": state_equal,
        "prefill_ms": r32.stats["prefill_ms"],
        "decode_ms_per_token": r32.stats["decode_ms_per_token"]}
    print(f"  mamba2 serve (f32), K4 on vs off and prefill + decode vs one "
          f"prefill: {json.dumps(drift['f32'])} (tolerance: layer 0 within "
          f"{SSD_SCALE_TOL} of its largest |output| + {SSD_REL_TOL['f32']} "
          f"relative; logits within {DRIFT_LOGITS_SHARE} of max |logit|, "
          f"greedy tokens equal at >= {EQUAL_TOKENS_MIN})", flush=True)
    check(bool(((on - off).abs() <= SSD_SCALE_TOL * off.abs().max()
                + SSD_REL_TOL["f32"] * off.abs()).all()),
          f"f32 layer 0 mixer, K4 on vs off: max |d| {layer0_err}")
    check(kernel[0] <= DRIFT_LOGITS_SHARE * kernel[1],
          f"f32 logits drift {kernel[0]} over {DRIFT_LOGITS_SHARE} x "
          f"{kernel[1]}")
    check(kernel[2] >= EQUAL_TOKENS_MIN, f"f32 equal next tokens {kernel[2]}")
    check(state_equal >= EQUAL_TOKENS_MIN,
          f"f32 recurrent decode agrees with one prefill at {state_equal}")
    return st, cnt, drift


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
    from repro_torch.card import peaks
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
    peak_name, (bw, f32_peak, bf16_peak) = peaks(card)
    print(f"[1] card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | peaks of {peak_name}: {bw / 1e12} TB/s, "
          f"{f32_peak / 1e12} TFLOP/s f32, {bf16_peak / 1e12} TFLOP/s bf16 "
          "tensor", flush=True)
    t0 = time.time()
    libs = build.build(verbose=True)
    for name in libs:
        build.library(name)
    print(f"[1] built {sorted(p.name for p in libs.values())} in "
          f"{time.time() - t0:.2f} s", flush=True)
    sass = sass_ops(build, "ota_kernels", ("LDG.E.128", "STG.E.128"))
    print(f"[1] 128-bit global loads and stores in the OTA library: "
          f"{json.dumps(sass)}", flush=True)
    ota = {fn: n for fn, n in sass.items()
           if "round_step_kernel" in fn or "aggregate_kernel" in fn}
    check(len(ota) == 5 and all(n["LDG.E.128"] > 0 and n["STG.E.128"] > 0
                                for n in ota.values()),
          f"a K1/K2 instance (K1 f32, bf16, int8; K2 f32, bf16) has no "
          f"128-bit global load or store: {ota}")
    sass = sass_ops(build, "flash_attention")
    print(f"[1] tensor-core instructions in the flash-attention library: "
          f"{json.dumps(sass)}", flush=True)
    bf16_kernels = {fn: n for fn, n in sass.items()
                    if "flash_attention_kernel_bf16" in fn}
    check(len(bf16_kernels) == 2 and all(
        n["HGMMA"] + n["HMMA"] > 0 for n in bf16_kernels.values()),
        f"K3's bf16 kernel (Dh 64 and 128) has no tensor-core instruction: "
        f"{bf16_kernels}")
    f32_kernels = {fn: n for fn, n in sass.items()
                   if "flash_attention_kernel_f32" in fn}
    check(len(f32_kernels) == 2 and all(
        n["HMMA"] > 0 for n in f32_kernels.values()),
        f"K3's f32 kernel (Dh 64 and 128) has no HMMA: {f32_kernels}")
    regs = build.ptxas_report(build.log("flash_attention"),
                              "flash_attention_kernel_f32")
    print(f"[1] K3 f32 registers and spills: {json.dumps(regs)}", flush=True)
    spills = [int(n) for line in regs
              for n in re.findall(r"(\d+) bytes spill", line)]
    check(len(spills) == 4 and not any(spills),
          f"K3's f32 kernel spills, or its build log was not read: {regs}")
    sass = sass_ops(build, "ssd_scan")
    print(f"[1] tensor-core instructions in the ssd_scan library: "
          f"{json.dumps(sass)}", flush=True)
    f32_kernels = {fn: n for fn, n in sass.items()
                   if "ssd_scan_kernelIf" in fn}
    check(len(f32_kernels) == 16 and all(
        n["HMMA"] > 0 for n in f32_kernels.values()),
        f"K4's f32 kernel (16 P, N pairs) has no HMMA: {f32_kernels}")

    print("[2] kernels vs plain versions on the card", flush=True)
    kres = phase_kernels(torch, dev, card)
    ares = phase_attention_kernel(torch, dev, card)
    sres = phase_ssd_kernel(torch, dev, card)
    print("[3] fleet main path at full width", flush=True)
    world = design_world(torch, dev)
    main_counts, path_counts, walls = phase_main_path(torch, np, dev, world)
    print("[4] fleet kernels on vs forced off, same draws", flush=True)
    phase_kernels_vs_plain_path(torch, dev, world)
    print("[5] the Fig.-2 path: sca design, curves gate, kill and resume",
          flush=True)
    curve_stats = phase_curves(torch, np, dev, world)
    print("[6] LM serve path at full width", flush=True)
    serve_stats, serve_counts, f32_counts, drift, swa = phase_serve(torch,
                                                                     dev)
    print("[7] Mamba-2 serve path at full width", flush=True)
    ssd_stats, ssd_counts, ssd_drift = phase_serve_ssd(torch, dev)
    print("[8] the heterogeneous-wireless path: scenarios, the grid through "
          "K1, adaptive_sca", flush=True)
    scen = phase_scenarios(torch, np, dev, card, card_line)
    print("[9] the single-run API: run_fl, run_fl_legacy, fig2 --bench",
          flush=True)
    single = phase_single_run(torch, np, dev, world, card_line)
    print("[10] population mode: a 1M-device population, streamed cohorts, "
          "adaptive_sca's cohort redesign, through K1", flush=True)
    popr = phase_population(torch, np, dev, card, card_line, world)
    print("[11] the cifar_conv fleet with run telemetry: fig2 --task "
          "cifar_conv --telemetry through K1", flush=True)
    cifar = phase_cifar(torch, np, dev, card, card_line, world)

    launches = {("ota_round_step", "f32"): main_counts["ota_round_step"],
                ("ota_round_step", "bf16"):
                    path_counts["fused_bf16"]["ota_round_step"],
                ("ota_round_step", "int8"):
                    path_counts["fused_int8"]["ota_round_step"],
                ("ota_aggregate", "f32"):
                    path_counts["unfused_f32"]["ota_aggregate"]}
    rows = [(f"{name}[{wire}]", name, n_launch, kres[(name, wire, MAIN[2])])
            for (name, wire), n_launch in launches.items()]
    rows.append(("flash_attention[bf16]", "flash_attention",
                 serve_counts["flash_attention"], ares["main"]))
    rows.append(("flash_attention[f32]", "flash_attention",
                 f32_counts["flash_attention"], ares["main_f32"]))
    rows.append(("ssd_scan[f32]", "ssd_scan", ssd_counts["ssd_scan"],
                 sres[SSD_MAIN[0]]))
    rows.append((f"ota_round_step[f32, grid C={GRID_CELLS}]",
                 "ota_round_step", scen["grid_k1"], scen["k1_row"]))
    rows.append((f"ota_round_step[f32, cohort C=1 N={POP_COHORT}]",
                 "ota_round_step", popr["k1_launches"], popr["k1_row"]))
    rows.append((f"ota_round_step[f32, cifar C={CIFAR[0]} D={CIFAR[2]}]",
                 "ota_round_step", cifar["k1_launches"], cifar["k1_row"]))
    kernels = [{
        "name": label, "route": "cuda", "source": SOURCES[name],
        "replaces": REPLACES[name], "launches": n_launch,
        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row.get("library_ms")}
        for label, name, n_launch, row in rows]
    agg_bf16 = kres[("ota_aggregate", "bf16", MAIN[2])]
    print(f"[12] ota_aggregate[bf16] (no path hands K2 a bf16 g): "
          f"{json.dumps(agg_bf16)}", flush=True)
    print(f"[12] round walls ms: {json.dumps(walls)}", flush=True)
    print(f"[12] curves: {json.dumps(curve_stats)}", flush=True)
    print(f"[12] scenarios: {json.dumps(scen['walls'])}", flush=True)
    print(f"[12] single run: {json.dumps(single)}", flush=True)
    print(f"[12] population: {json.dumps(popr['walls'])}", flush=True)
    print(f"[12] cifar_conv with telemetry: {json.dumps(cifar['walls'])}",
          flush=True)
    print(f"[12] serve: prefill {serve_stats['prefill_ms']:.3f} ms, decode "
          f"{serve_stats['decode_ms_per_token']:.3f} ms per token "
          f"(batch {serve_stats['batch']}); f32 prefill "
          f"{drift['f32']['prefill_ms']:.3f} ms, decode "
          f"{drift['f32']['decode_ms_per_token']:.3f} ms per token; swa prefill "
          f"{swa['prefill_ms']:.3f} ms, decode "
          f"{swa['decode_ms_per_token']:.3f} ms per token; mamba2 prefill "
          f"{ssd_stats['prefill_ms']:.3f} ms, decode "
          f"{ssd_stats['decode_ms_per_token']:.3f} ms per token; total "
          f"{time.time() - t_start:.1f} s", flush=True)
    print(card_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
