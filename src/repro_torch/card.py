"""The card's published peaks and the batched CUDA-event timer, shared by
``chip_smoke.py`` and ``python -m repro_torch.profile_ota``."""
from __future__ import annotations

import statistics

import torch

# published peaks per card (data sheets, dense): (device-memory bytes/s, f32
# flop/s outside the tensor cores, bf16 tensor-core flop/s; TF32 runs at
# half the bf16 rate); an unknown name falls back to the H100 SXM
PEAKS = {"H100 PCIe": (2.0e12, 51e12, 756e12),
         "H100 NVL": (3.9e12, 60e12, 835e12),
         "H200": (4.8e12, 67e12, 989e12), "H100": (3.35e12, 67e12, 989e12)}


# the card's link to the other cards, bytes/s each way (data sheets): the
# H100 SXM's and the H200's NVLink 4, 900 GB/s in all over 18 links, 450
# GB/s each way; the PCIe card's and the NVL's NVLink bridge, 600 GB/s,
# 300 each way.  Between nodes traffic crosses a slower network (a 400
# Gb/s InfiniBand port a card is 50 GB/s), so a collective term at this
# rate is a lower bound for a mesh of more than one node.
LINKS = {"H100 PCIe": 300e9, "H100 NVL": 300e9, "H200": 450e9,
         "H100": 450e9}


def link_rate(name: str):
    """(matched name, bytes/s each way over the card's NVLink)."""
    for key, val in LINKS.items():
        if key in name:
            return key, val
    return "H100 (assumed)", LINKS["H100"]


def peaks(name: str):
    """(matched name, (bytes/s, f32 flop/s, bf16 tensor flop/s))."""
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    return "H100 (assumed)", PEAKS["H100"]


def median_ms(fn, iters=20, batches=5, warmup=3) -> float:
    """Median over ``batches`` of the mean time of ``iters`` back-to-back
    calls between two CUDA events: the device's queue stays full, so the
    host's time per call (a wrapper's checks, allocation, launch: tens of
    microseconds) does not enter the time of a kernel that takes longer."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)
