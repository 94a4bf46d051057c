"""Non-iid federated data partitioning (the paper's §IV ring protocol).

A copy of ``repro.data.partition``'s ``partition_by_label`` and
``stack_shards``, kept so the port never imports the JAX package.  Each
device holds samples of exactly ``labels_per_device`` digits, and any label
appears on at most ``max_devices_per_label`` devices: with N = 10, 2
labels/device and <= 2 devices/label, device m <- {m, (m+1) mod 10}.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def label_assignment(num_devices: int, num_classes: int,
                     labels_per_device: int = 2,
                     max_devices_per_label: int = 2) -> List[Tuple[int, ...]]:
    """Ring assignment: device m gets labels {m, m+1, ...} mod num_classes."""
    total_slots = num_devices * labels_per_device
    if total_slots > num_classes * max_devices_per_label:
        raise ValueError("infeasible: label slots exceed device-per-label cap")
    out = []
    for m in range(num_devices):
        out.append(tuple((m + j) % num_classes
                         for j in range(labels_per_device)))
    # verify the cap
    counts = np.zeros(num_classes, int)
    for labs in out:
        for l in labs:
            counts[l] += 1
    assert counts.max() <= max_devices_per_label, counts
    return out


def partition_by_label(x: np.ndarray, y: np.ndarray, num_devices: int,
                       labels_per_device: int = 2,
                       max_devices_per_label: int = 2, seed: int = 0):
    """Split (x, y) across devices per the paper's non-iid protocol.

    Returns list of (x_m, y_m); each label's samples are split evenly among
    the devices owning it.  All devices end up with equal-size datasets when
    samples/class are uniform.
    """
    num_classes = int(y.max()) + 1
    assign = label_assignment(num_devices, num_classes, labels_per_device,
                              max_devices_per_label)
    rng = np.random.default_rng(seed)
    owners = {c: [m for m, labs in enumerate(assign) if c in labs]
              for c in range(num_classes)}
    shards = [[] for _ in range(num_devices)]
    for c, devs in owners.items():
        idx = np.where(y == c)[0]
        rng.shuffle(idx)
        for j, m in enumerate(devs):
            shards[m].append(idx[j::len(devs)])
    out = []
    for m in range(num_devices):
        idx = np.concatenate(shards[m]) if shards[m] else np.array([], int)
        rng.shuffle(idx)
        out.append((x[idx], y[idx]))
    return out


def stack_shards(shards):
    """Stack shards into arrays with leading device axis [N, ...]
    (rectangular, vmap-able across devices), truncated to the minimum
    shard size -- lossless for the ring protocol's equal shards.  (The
    reference's ``pad=True`` for unequal Dirichlet shards comes with
    cifar_conv.)
    """
    n = min(len(s[1]) for s in shards)
    xs = np.stack([s[0][:n] for s in shards])
    ys = np.stack([s[1][:n] for s in shards])
    return xs, ys
