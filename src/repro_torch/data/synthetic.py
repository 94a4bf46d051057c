"""Synthetic MNIST-like dataset (no downloads).

A copy of ``repro.data.synthetic.mnist_like``, kept so the port never
imports the JAX package; its arrays equal the reference's bit for bit.
Each class is a smoothed random template; samples are template + Gaussian
pixel noise.
"""
from __future__ import annotations

import numpy as np

IMG_DIM = 784
NUM_CLASSES = 10


def mnist_like(samples_per_class: int = 1000, num_classes: int = NUM_CLASSES,
               noise: float = 0.35, seed: int = 0,
               test_per_class: int = 100):
    """Returns (x_train, y_train, x_test, y_test); x in [0,1]^784."""
    rng = np.random.default_rng(seed)
    # class templates: sparse blobs smoothed by a box filter
    templates = []
    for _ in range(num_classes):
        img = np.zeros((28, 28))
        for _ in range(6):
            cx, cy = rng.integers(4, 24, size=2)
            img[max(0, cx - 3):cx + 3, max(0, cy - 3):cy + 3] += rng.uniform(0.5, 1.0)
        # cheap smoothing
        k = np.ones((3, 3)) / 9.0
        pad = np.pad(img, 1)
        img = sum(pad[i:i + 28, j:j + 28] * k[i, j]
                  for i in range(3) for j in range(3))
        templates.append(img.reshape(-1))
    templates = np.stack(templates)
    templates /= templates.max(axis=1, keepdims=True) + 1e-9

    def make(n_per):
        xs, ys = [], []
        for c in range(num_classes):
            x = templates[c][None] + noise * rng.standard_normal((n_per, IMG_DIM))
            xs.append(np.clip(x, 0.0, 1.0))
            ys.append(np.full(n_per, c, dtype=np.int32))
        x = np.concatenate(xs).astype(np.float32)
        y = np.concatenate(ys)
        perm = rng.permutation(len(y))
        return x[perm], y[perm]

    x_tr, y_tr = make(samples_per_class)
    x_te, y_te = make(test_per_class)
    return x_tr, y_tr, x_te, y_te
