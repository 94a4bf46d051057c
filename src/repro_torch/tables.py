"""Markdown tables of the dry-run's records: the port of
``benchmarks/tables.py``.

    PYTHONPATH=src python -m repro_torch.tables

``dryrun_table`` renders a record as the reference's does (the port's
records have its keys: ``collective_bytes_per_device`` all 0 on one
card); ``roofline_table`` the reference's roofline columns at the card's
peaks (``roofline.roofline_row``: reckoned from the published peaks, not
measured).  A record's kernel tally (K3 and K4 by their own work) is in
its ``kernels``.
"""
from __future__ import annotations

import argparse

from repro_torch import roofline
from repro_torch.card import peaks


def dryrun_table(records: list) -> str:
    lines = ["| arch | shape | devices | params | HLO GFLOP/dev | HLO GB/dev "
             "| coll GB/dev (ar/ag/rs/a2a/cp) | args GB/dev | compile s |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(records, key=lambda r: (r["arch"], r["shape"])):
        coll = r["collective_bytes_per_device"]
        fl = r.get("flops_per_device_corrected", r["flops_per_device"])
        cl = r.get("collective_bytes_corrected", coll["total"])
        by = r.get("bytes_per_device_corrected",
                   r["bytes_accessed_per_device"])
        detail = "/".join(f"{coll.get(k, 0) / 1e9:.2f}"
                          for k in ("all-reduce", "all-gather",
                                    "reduce-scatter", "all-to-all",
                                    "collective-permute"))
        arg_gb = r["memory_analysis"].get("argument_bytes", 0) / 1e9
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['devices']} "
            f"| {r['num_params'] / 1e9:.2f}B | {fl / 1e9:.0f} "
            f"| {by / 1e9:.1f} | {cl / 1e9:.2f} ({detail}) "
            f"| {arg_gb:.2f} | {r['compile_s']} |")
    return "\n".join(lines)


def roofline_table(records: list) -> str:
    lines = ["| arch | shape | compute s | memory s | collective s "
             "| dominant | MODEL_FLOPS/dev | useful ratio |",
             "|---|---|---|---|---|---|---|---|"]
    for r in records:
        row = roofline.roofline_row(r)
        lines.append(
            f"| {row['arch']} | {row['shape']} | {row['compute_s']:.3f} "
            f"| {row['memory_s']:.3f} | {row['collective_s']:.3f} "
            f"| **{row['dominant']}** "
            f"| {row['model_flops_per_device']:.3e} "
            f"| {row['useful_flops_ratio']:.3f} |")
    return "\n".join(lines)


def main(argv=None):
    argparse.ArgumentParser(description=__doc__).parse_args(argv)
    records = roofline.load_records()
    cards = []
    for name in sorted({r.get("card", "H100") for r in records}):
        _, (bw, _, bf16) = peaks(name)
        cards.append(f"{name}: {bw / 1e12:g} TB/s, {bf16 / 1e12:g} TFLOP/s "
                     "bf16")
    print("### Dry-run (one card)\n")
    print(dryrun_table(records))
    print(f"\n### Roofline (one card; reckoned from the published peaks, "
          f"{'; '.join(cards)}; not measured)\n")
    print(roofline_table(records))


if __name__ == "__main__":
    main()
