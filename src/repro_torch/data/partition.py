"""Non-iid federated data partitioning: the paper's §IV ring protocol and
the Dirichlet(alpha) label split of the cifar_conv task.

A copy of ``repro.data.partition``'s ``partition_by_label``,
``partition_dirichlet`` and ``stack_shards``, kept so the port never
imports the JAX package.  Ring protocol: each
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


def partition_dirichlet(x: np.ndarray, y: np.ndarray, num_devices: int,
                        alpha: float = 0.5, seed: int = 0,
                        min_per_device: int = 1):
    """Dirichlet(alpha) label partition across ``num_devices`` devices.

    For each class c the class's (shuffled) samples are split into
    contiguous chunks sized by a draw pi_c ~ Dirichlet(alpha 1_N), so the
    total sample count is conserved exactly.  Small alpha concentrates
    each class on few devices (strong label skew).  ``min_per_device``
    repairs pathological draws (a device with fewer samples steals from
    the largest shard).  Returns a list of (x_m, y_m), one per device.
    """
    if alpha <= 0:
        raise ValueError(f"alpha must be > 0, got {alpha}")
    num_classes = int(y.max()) + 1
    rng = np.random.default_rng(seed)
    assign = [[] for _ in range(num_devices)]
    for c in range(num_classes):
        idx = np.where(y == c)[0]
        rng.shuffle(idx)
        pi = rng.dirichlet(np.full(num_devices, float(alpha)))
        # contiguous-chunk split by cumulative shares: conserves samples
        cuts = np.floor(np.cumsum(pi) * len(idx)).astype(int)
        cuts[-1] = len(idx)
        start = 0
        for m, stop in enumerate(cuts):
            if stop > start:
                assign[m].append(idx[start:stop])
            start = stop
    shards_idx = [np.concatenate(a) if a else np.array([], dtype=int)
                  for a in assign]
    # repair: every device keeps at least min_per_device samples
    for m in range(num_devices):
        while len(shards_idx[m]) < min_per_device:
            donor = int(np.argmax([len(s) for s in shards_idx]))
            if len(shards_idx[donor]) <= min_per_device:
                raise ValueError("not enough samples to give every device "
                                 f"{min_per_device}")
            shards_idx[m] = np.concatenate([shards_idx[m],
                                            shards_idx[donor][-1:]])
            shards_idx[donor] = shards_idx[donor][:-1]
    out = []
    for m in range(num_devices):
        idx = shards_idx[m]
        rng.shuffle(idx)
        out.append((x[idx], y[idx]))
    return out


def stack_shards(shards, pad: bool = False):
    """Stack shards into arrays with leading device axis [N, ...]
    (rectangular, vmap-able across devices).

    pad=False truncates to the minimum shard size -- lossless for the ring
    protocol's equal shards.  pad=True rectangularizes unequal
    (Dirichlet) shards to the LARGEST by cyclic repetition of each shard's
    rows, so no sample is discarded.
    """
    sizes = [len(s[1]) for s in shards]
    n = max(sizes) if pad else min(sizes)

    def fit(a):
        if len(a) >= n:
            return a[:n]
        reps = -(-n // len(a))
        return np.concatenate([a] * reps)[:n]

    xs = np.stack([fit(s[0]) for s in shards])
    ys = np.stack([fit(s[1]) for s in shards])
    return xs, ys
