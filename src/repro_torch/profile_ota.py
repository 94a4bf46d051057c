"""K1 and K2 at the fleet's main shape on the card, against other builds of
their source.

    python -m repro_torch.profile_ota [--against LABEL=PATH] [--reps 4]

Builds ``kernels/csrc/ota_kernels.cu`` (label ``this``) and each
``--against`` source (another checkout's ``ota_kernels.cu``) with nvcc for
sm_90a and ``-Xptxas -v``, one process each, all at once, and prints each
kernel's registers and spills.  Every build exports the same C entry
points.  At the fleet's main shape (C = 7 cells, N = 10 devices, D =
814,090) it launches K1 on the f32, bf16 and int8 wires and K2 on f32 and
bf16 through each build, compares each output with the plain version
(``torch.equal``), then times each (``card.median_ms``: CUDA events around
batches of 20 back-to-back launches, the median of 5 batches) in
``--reps`` rounds whose build order alternates (A B, B A, ...).  Per
kernel and build it prints the median of the rounds' medians, the achieved
GB/s and the share of the byte bound: the bytes of each input read once
and the output written once, over the card's data-sheet memory rate.  For
scale it times one PyTorch pass of the same reach, ``torch.sum(g, dim=1)``
on the f32 and bf16 g (what a streaming reduction of the library attains
on this card).  The last line is one JSON object.  Fails if this source's
kernels are not bitwise equal to the plain versions.  Needs a CUDA device.

``draw`` and ``ota_cases`` also make ``chip_smoke.py``'s K1/K2 rows.
"""
from __future__ import annotations

import argparse
import json
import statistics
from pathlib import Path

import torch

from repro_torch.card import median_ms, peaks
from repro_torch.device import resolve_device
from repro_torch.kernels import build, ops, ref

MAIN = (7, 10, 814_090)              # cells, devices, d of the main path


def draw(shape, dev, gen):
    """(g, s, z, ns, p, eta) of one round tail; the last device of every
    cell is truncated (s = 0)."""
    c, n, d = shape
    g = torch.randn((c, n, d), generator=gen, device=dev)
    s = torch.rand((c, n), generator=gen, device=dev) * 0.2
    s[:, -1] = 0.0
    z = torch.randn((c, d), generator=gen, device=dev)
    p = torch.randn((c, d), generator=gen, device=dev)
    ns = torch.rand((c,), generator=gen, device=dev) * 0.1
    eta = torch.rand((c,), generator=gen, device=dev) * 0.1
    return g, s, z, ns, p, eta


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def ota_cases(g, s, z, ns, p, eta):
    """[(entry, wire, args, plain, bytes, flops)]: K1 (``ota_round_step``)
    on the f32, bf16 and int8 wires and K2 (``ota_aggregate``) on f32 and
    bf16, over one draw.  ``args`` are the kernel's inputs in the order of
    its wrapper and its C entry; ``plain()`` computes the plain version;
    bytes count each input read once and the output written once; flops
    are the kernel's f32 operations."""
    c, n, d = g.shape
    cases = []
    for wire in ("f32", "bf16", "int8"):
        w, qs = ops.quantize_uplink(g, wire)
        args = (w, torch.ones_like(s) if qs is None else qs, s, z, ns, p, eta)
        cases.append(("ota_round_step", wire, args,
                      lambda w=w, qs=qs: ref.ota_round_step_ref(
                          w, s, z, ns, p, eta, qs),
                      nbytes(*args) + c * d * 4, c * d * (3 * n + 4)))
    for wire, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        args = (g.to(dtype), s, z, ns)
        cases.append(("ota_aggregate", wire, args,
                      lambda args=args: ref.ota_aggregate_ref(*args),
                      nbytes(*args) + c * d * args[0].element_size(),
                      c * d * (2 * n + 2)))
    return cases


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", action="append", default=[],
                    metavar="LABEL=PATH")
    ap.add_argument("--reps", type=int, default=4)
    a = ap.parse_args(argv)
    dev = resolve_device(None)
    card = torch.cuda.get_device_name(0)
    sources = {"this": build.SOURCES["ota_kernels"]}
    for spec in a.against:
        label, path = spec.split("=", 1)
        sources[label] = Path(path)
    libs = build.build_variants("ota_kernels", sources, "round_step_kernel",
                                "aggregate_kernel")

    _, (bw, _, _) = peaks(card)
    labels = list(libs)
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for entry, wire, args, plain, nb, _ in ota_cases(*draw(MAIN, dev, gen)):
        name = f"{'K1' if entry == 'ota_round_step' else 'K2'} {wire}"
        want = plain()
        out = torch.empty_like(want)

        def launch(lib, entry=entry, wire=wire, args=args, out=out):
            err = getattr(lib, f"{entry}_{wire}")(
                *(t.data_ptr() for t in args), out.data_ptr(), *MAIN, stream)
            build.check(err, f"{entry}_{wire}")
            return out
        row = {"bytes": nb, "bound_ms": 1e3 * nb / bw}
        for label in labels:
            got = launch(libs[label])
            torch.cuda.synchronize()
            row[label] = {"equal": bool(torch.equal(got, want)),
                          "max_abs_err": float((got.float() - want.float())
                                               .abs().max()), "ms_reps": []}
        for rep in range(a.reps):
            for label in labels if rep % 2 == 0 else labels[::-1]:
                row[label]["ms_reps"].append(
                    median_ms(lambda: launch(libs[label])))
        for label in labels:
            r = row[label]
            r["ms"] = statistics.median(r["ms_reps"])
            r["gb_per_s"] = nb / r["ms"] / 1e6
            r["bound_share"] = row["bound_ms"] / r["ms"]
        results[name] = row
        print(f"{name}: " + json.dumps(row), flush=True)
        if not row["this"]["equal"]:
            raise SystemExit(f"{name}: this source's kernel is not bitwise "
                             "equal to the plain version")
    c, n, d = MAIN
    gen = torch.Generator(device=dev).manual_seed(1)
    g = torch.randn((c, n, d), generator=gen, device=dev)
    reach = {}
    for wire, gd in (("f32", g), ("bf16", g.to(torch.bfloat16))):
        nb = gd.numel() * gd.element_size() * (n + 1) // n
        ms = median_ms(lambda: torch.sum(gd, dim=1))
        reach[f"torch.sum(g, 1) {wire}"] = {
            "bytes": nb, "ms": ms, "gb_per_s": nb / ms / 1e6,
            "bound_share": 1e3 * nb / bw / ms}
        print(f"torch.sum(g, 1) {wire}: "
              + json.dumps(reach[f"torch.sum(g, 1) {wire}"]), flush=True)
    del g
    print(json.dumps({"card": card, "shape": MAIN, "bytes_per_s": bw,
                      "reach": {k: v["ms"] for k, v in reach.items()},
                      "kernels": {name: {label: row[label]["ms"]
                                         for label in labels}
                                  | {"bound_ms": row["bound_ms"]}
                                  for name, row in results.items()}}),
          flush=True)


if __name__ == "__main__":
    main()
