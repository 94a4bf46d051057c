"""Kernel micro-benchmarks on the port, ported from
``benchmarks/kernel_bench.py``: the kernels against their plain versions
and oracles, with times, bounds and errors.

    python -m repro_torch.kernel_bench [--smoke] [--device cuda]

``run`` keeps the reference's rows:

  ota_aggregate_d814k    K2 at the paper's scale (N 10, d 814,090) against
                         ``ota_aggregate_ref`` (bitwise on the card);
  attention_ref_2k_full  K3 in f32, causal, at B 1, S 2,048, H 8 over
                         KH 2, Dh 64, beside its plain version and one
                         ``scaled_dot_product_attention`` call (the
                         reference times its jnp attention here);
  ssd_chunked_1k         K4 at B 1, S 1,024, H 8, P 64, G 1, N 64 against
                         the sequential oracle ``ref.ssd_ref``, with its
                         speedup over it; the plain chunked scan is held
                         against the oracle too.

Each row carries the kernel's time (``us_per_call``), its plain
version's, the bound (``bound_us``: the larger of the bytes moved over the
memory rate and the operations over the peak rate, ``card.peaks``) and the
largest error; ``run`` raises if a kernel or the chunked scan disagrees.

``round_step_rows`` is the fused-vs-unfused section, per uplink dtype
(f32, bf16, int8): fused is one K1 launch; unfused is K2 on the
dequantized wire with ghat materialized, then the SGD update as its own
launch.  Its columns, bytes and rounding are the reference's.
``round_step_equivalence`` holds K1 against its plain version on the three
wires at d 5,000 (the reference's interpret-mode gate).  ``--smoke`` runs
that gate, then the rows at n 4, d 65,536, with the reference's
assertions.

Times on the card are ``card.median_ms`` (CUDA events around batches of
back-to-back calls); every tensor is drawn there.  On the CPU every call
takes the plain versions and the times are host walls, which mean
nothing; the rows and the assertions still hold.
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.nn.functional as F

from repro_torch.card import median_ms, peaks
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan

UPLINKS = ("f32", "bf16", "int8")
_WIRE_BYTES = {"f32": 4, "bf16": 2, "int8": 1}
OTA = (10, 814_090)                     # devices, d
# K3's row: a ``profile_attention.Shape`` (label, B, S, H, KH, Dh, dtype)
ATTN = ("kernel_bench_2k", 1, 2048, 8, 2, 64, "f32")
SSD = (1, 1024, 8, 64, 1, 64)           # B, S, H, P, G, N
SSD_CHUNK = 128
# ``card.median_ms``'s batches and warm-up calls: a timed call on the card
# launches its kernel WARMUP + BATCHES x iters times
BATCHES, WARMUP = 5, 2
# ``--smoke``'s round-step rows
SMOKE_ROWS = dict(n=4, d=65_536, iters=2)
F32_TOL = dict(rtol=2e-5, atol=2e-5)
# the chunked scan and K4 against the sequential oracle: the two forms
# round differently (tests/test_torch_ssm.py's 2e-4), over an error scale
# of the output's largest magnitude
SSD_SCALE_TOL, SSD_REL_TOL = 1e-4, 2e-4


def _card(dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _time_us(fn, dev, iters: int) -> float:
    """Microseconds a call: ``card.median_ms`` on the card (batches of
    ``iters`` back-to-back calls), the host wall's mean on the CPU."""
    if dev.type == "cuda":
        return 1e3 * median_ms(fn, iters=iters, batches=BATCHES,
                               warmup=WARMUP)
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e6


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _bound_us(byts: int, flops: float, card: str, tensor_cores=False):
    """(microseconds, "bytes" | "operations"): the larger of the bytes over
    the memory rate and the f32 operations over the cheaper of the FMA
    units and, with ``tensor_cores``, three TF32 products."""
    _, (bw, f32_peak, bf16_peak) = peaks(card)
    ops_s = flops / f32_peak
    if tensor_cores:
        ops_s = min(ops_s, 3 * flops / (bf16_peak / 2))
    return 1e6 * max(byts / bw, ops_s), \
        "bytes" if byts / bw >= ops_s else "operations"


def ssd_flops(b, s, h, p, n, g, state0) -> int:
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


def _ssd_ok(got, want) -> tuple:
    """(max abs error, within SSD_SCALE_TOL of want's largest plus
    SSD_REL_TOL relative)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool((err <= SSD_SCALE_TOL * float(want.abs().max())
               + SSD_REL_TOL * want.abs()).all())
    return float(err.max()), ok


def run(device=None, iters: int = 20) -> list:
    """The reference's three rows, each kernel held against its plain
    version (and K4 and the chunked scan against the sequential oracle);
    raises AssertionError on a disagreement."""
    from repro_torch.profile_attention import (Shape, bound, draw, sdpa,
                                               sdpa_backend)
    dev = resolve_device(device)
    card = _card(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

    # OTA aggregation at the paper's scale, one cell: K2
    n, d = OTA
    g = torch.randn((1, n, d), generator=gen, device=dev)
    s = torch.rand((1, n), generator=gen, device=dev)
    z = torch.randn((1, d), generator=gen, device=dev)
    ns = torch.full((1,), 0.2, device=dev)
    out = ops.ota_aggregate_flat(g, s, z, ns)
    want = ref.ota_aggregate_ref(g, s, z, ns)
    bitwise = bool(torch.equal(out, want))
    us, by = _bound_us(nbytes(g, s, z, ns, out), d * (2 * n + 2), card)
    rows.append({"bench": "ota_aggregate_d814k",
                 "us_per_call": _time_us(
                     lambda: ops.ota_aggregate_flat(g, s, z, ns), dev, iters),
                 "kernel_max_err": float((out - want).abs().max()),
                 "bitwise": bitwise,
                 "plain_us": _time_us(
                     lambda: ref.ota_aggregate_ref(g, s, z, ns), dev, iters),
                 "bound_us": us, "bound_by": by, "device": card})
    assert bitwise, "K2 is not bitwise equal to its plain version"
    del g, s, z, out, want

    # attention at 2k, f32, causal: K3 beside its plain version and SDPA
    shape = Shape(*ATTN)
    q, k, v = draw(shape, dev, gen)
    out = flash_attention(q, k, v, causal=True)
    want = ref.attention_ref(q, k, v, causal=True)
    err = (out - want).abs()
    ok = bool((err <= F32_TOL["atol"] + F32_TOL["rtol"] * want.abs()).all())
    library = sdpa(q, k, v, None, True)
    backend, _ = sdpa_backend(library)
    bd = bound(shape, card)
    rows.append({"bench": "attention_ref_2k_full",
                 "us_per_call": _time_us(
                     lambda: flash_attention(q, k, v, causal=True), dev,
                     iters),
                 "max_err": float(err.max()), "tol": F32_TOL["rtol"],
                 "plain_us": _time_us(
                     lambda: ref.attention_ref(q, k, v, causal=True), dev,
                     iters),
                 "sdpa_us": _time_us(library, dev, iters) if backend
                 else None, "sdpa_backend": backend,
                 "bound_us": 1e3 * bd["bound_ms"], "bound_by": bd["bound_by"],
                 "device": card})
    assert ok, f"K3 disagrees with its plain version: {float(err.max())}"
    del q, k, v, out, want, err

    # the SSD scan at S 1,024: K4 and the chunked scan against the
    # sequential oracle
    b, sl, h, p, gg, nn = SSD

    def randn(*shp):
        return torch.randn(shp, generator=gen, device=dev)
    x = randn(b, sl, h, p)
    dt = F.softplus(randn(b, sl, h))
    a_neg = -torch.exp(0.5 * randn(h))
    bm, cm = 0.3 * randn(b, sl, gg, nn), 0.3 * randn(b, sl, gg, nn)
    y, st = ssd_scan(x, dt, a_neg, bm, cm, chunk=SSD_CHUNK)
    y_chunked, _ = ref.ssd_chunked(x, dt, a_neg, bm, cm, SSD_CHUNK)
    y_seq = ref.ssd_ref(x, dt, a_neg, bm, cm)
    err, ok = _ssd_ok(y, y_seq)
    chunked_err, chunked_ok = _ssd_ok(y_chunked, y_seq)
    t_k = _time_us(lambda: ssd_scan(x, dt, a_neg, bm, cm, chunk=SSD_CHUNK),
                   dev, iters)
    t_seq = _time_us(lambda: ref.ssd_ref(x, dt, a_neg, bm, cm), dev,
                     max(1, iters // 10))
    us, by = _bound_us(nbytes(x, dt, a_neg, bm, cm, y, st),
                       ssd_flops(b, sl, h, p, nn, gg, False), card,
                       tensor_cores=True)
    rows.append({"bench": "ssd_chunked_1k", "us_per_call": t_k,
                 "speedup_vs_sequential": t_seq / t_k, "max_err": err,
                 "chunked_max_err": chunked_err, "sequential_us": t_seq,
                 "plain_us": _time_us(lambda: ref.ssd_chunked(
                     x, dt, a_neg, bm, cm, SSD_CHUNK), dev, iters),
                 "bound_us": us, "bound_by": by, "library_us": None,
                 "device": card})
    assert ok, f"K4 disagrees with the sequential oracle: {err}"
    assert chunked_ok, f"the chunked scan disagrees with the oracle: " \
        f"{chunked_err}"
    return rows


def round_step_rows(n: int = 10, d: int = 814_090, iters: int = 5,
                    device=None) -> list:
    """Fused vs unfused round-step times and bytes per uplink dtype, one
    cell: fused is K1 (dequantize, aggregate, noise and step in one
    launch); unfused is ``dequantize_uplink``, K2 with ghat written out,
    then ``p - eta ghat`` as its own launch.  Quantizing is left out of
    both.  ``uplink_mb`` is what the N devices send; ``fused_bytes_mb``
    the receiver's traffic of one fused pass (wire, z and params in,
    params out); the unfused chain adds ghat's write and read.  On the
    card ``iters`` is the batch of ``card.median_ms``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    g = torch.randn((1, n, d), generator=gen, device=dev)
    s = 0.1 + 0.9 * torch.rand((1, n), generator=gen, device=dev)
    z = torch.randn((1, d), generator=gen, device=dev)
    p = torch.randn((1, d), generator=gen, device=dev)
    ns = torch.full((1,), 0.2, device=dev)
    eta = torch.full((1,), 0.05, device=dev)
    rows, base = [], None
    for ud in UPLINKS:
        wire, q_scale = ops.quantize_uplink(g, ud)

        def fused(wire=wire, q_scale=q_scale):
            return ops.ota_round_step_flat(wire, s, z, ns, p, eta, q_scale)

        def unfused(wire=wire, q_scale=q_scale):
            ghat = ops.ota_aggregate_flat(
                ops.dequantize_uplink(wire, q_scale), s, z, ns)
            return p - eta[:, None] * ghat
        t_f, t_u = _time_us(fused, dev, iters), _time_us(unfused, dev, iters)
        out = fused()
        if base is None:
            base = out
        uplink_mb = n * d * _WIRE_BYTES[ud] / 1e6
        fused_mb = uplink_mb + 3 * d * 4 / 1e6
        unfused_mb = fused_mb + 2 * d * 4 / 1e6
        rows.append({"uplink_dtype": ud,
                     "fused_us": round(t_f, 1),
                     "unfused_us": round(t_u, 1),
                     "speedup": round(t_u / t_f, 2),
                     "uplink_mb": round(uplink_mb, 2),
                     "fused_bytes_mb": round(fused_mb, 2),
                     "unfused_bytes_mb": round(unfused_mb, 2),
                     "max_err_vs_f32": float((out - base).abs().max())})
    return rows


def round_step_equivalence(n: int = 4, d: int = 5000, device=None) -> float:
    """K1 against its plain version on the f32, bf16 and int8 wires at a
    d off every vector boundary: the worst error (0 on the CPU, where
    both sides are the plain version; K1 is bitwise equal to it on the
    card)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(1)
    g = torch.randn((1, n, d), generator=gen, device=dev)
    s = 0.1 + 0.9 * torch.rand((1, n), generator=gen, device=dev)
    z = torch.randn((1, d), generator=gen, device=dev)
    p = torch.randn((1, d), generator=gen, device=dev)
    ns = torch.full((1,), 0.25, device=dev)
    eta = torch.full((1,), 0.05, device=dev)
    worst = 0.0
    for ud in UPLINKS:
        wire, q_scale = ops.quantize_uplink(g, ud)
        out = ops.ota_round_step_flat(wire, s, z, ns, p, eta, q_scale)
        exp = ops.ota_round_step_flat(wire, s, z, ns, p, eta, q_scale,
                                      use_kernel=False)
        worst = max(worst, float((out - exp).abs().max()))
    return worst


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the K1 equivalence gate, then the round-step "
                         "rows at n 4, d 65,536 (asserts)")
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    if a.smoke:
        err = round_step_equivalence(device=dev)
        assert err < 2e-5, f"round_step equivalence err {err}"
        print(f"round_step equivalence (K1 vs its plain version): "
              f"max_err={err:.2e} OK", flush=True)
        rows = round_step_rows(**SMOKE_ROWS, device=dev)
    else:
        rows = run(dev) + [{"bench": f"ota_round_step_{r['uplink_dtype']}",
                            **r} for r in round_step_rows(device=dev)]
    for row in rows:
        print(row, flush=True)
    if a.smoke:
        assert all(r["fused_us"] > 0 and r["unfused_us"] > 0 for r in rows)
        assert {r["uplink_dtype"] for r in rows} == set(UPLINKS)
        print("kernel_bench smoke OK", flush=True)


if __name__ == "__main__":
    main()
