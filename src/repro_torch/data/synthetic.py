"""Synthetic datasets (no downloads).

Copies of ``repro.data.synthetic.mnist_like``, ``cifar_like`` and
``token_stream``, kept so the port never imports the JAX package; their
arrays equal the reference's bit for bit.  Each image class is a smoothed
random template; samples are template + Gaussian pixel noise.  The token
stream is Zipf-distributed with short-range repetitions.
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


CIFAR_SHAPE = (32, 32, 3)
CIFAR_CLASSES = 10


def _smooth2d(img: np.ndarray, passes: int = 1) -> np.ndarray:
    """Cheap 3x3 box smoothing per channel (same trick as mnist_like)."""
    k = np.ones((3, 3)) / 9.0
    for _ in range(passes):
        pad = np.pad(img, ((1, 1), (1, 1), (0, 0)))
        img = sum(pad[i:i + img.shape[0], j:j + img.shape[1]] * k[i, j]
                  for i in range(3) for j in range(3))
    return img


def cifar_like(samples_per_class: int = 500,
               num_classes: int = CIFAR_CLASSES, noise: float = 0.25,
               seed: int = 0, test_per_class: int = 100):
    """Returns (x_train, y_train, x_test, y_test); x in [0,1]^(32,32,3).

    Per class: 8 random color blobs smoothed into a template, plus a
    class-indexed sinusoidal color wave (distinct dominant orientation and
    hue per class) so classes differ in both texture and global structure.
    Everything derives from ``seed``.
    """
    rng = np.random.default_rng(seed)
    h, w, c = CIFAR_SHAPE
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    templates = []
    for cls in range(num_classes):
        img = np.zeros((h, w, c))
        for _ in range(8):
            cx, cy = rng.integers(4, h - 4, size=2)
            color = rng.uniform(0.3, 1.0, size=c)
            img[max(0, cx - 4):cx + 4, max(0, cy - 4):cy + 4] += color
        # class-specific low-frequency wave: orientation indexed by class,
        # hue phase-shifted per channel
        theta = np.pi * cls / num_classes
        wave = np.sin((xx * np.cos(theta) + yy * np.sin(theta))
                      * (2 * np.pi / 16.0))
        phases = rng.uniform(0, 2 * np.pi, size=c)
        img += 0.35 * np.cos(wave[..., None] * np.pi + phases)
        img = _smooth2d(img, passes=2)
        img -= img.min()
        img /= img.max() + 1e-9
        templates.append(img)
    templates = np.stack(templates)                     # [C, 32, 32, 3]

    def make(n_per):
        xs, ys = [], []
        for cls in range(num_classes):
            x = templates[cls][None] \
                + noise * rng.standard_normal((n_per, h, w, c))
            xs.append(np.clip(x, 0.0, 1.0))
            ys.append(np.full(n_per, cls, dtype=np.int32))
        x = np.concatenate(xs).astype(np.float32)
        y = np.concatenate(ys)
        perm = rng.permutation(len(y))
        return x[perm], y[perm]

    x_tr, y_tr = make(samples_per_class)
    x_te, y_te = make(test_per_class)
    return x_tr, y_tr, x_te, y_te


def token_stream(num_tokens: int, vocab_size: int, seed: int = 0,
                 order: float = 1.2) -> np.ndarray:
    """Zipf-distributed token stream with short-range repetition structure."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = ranks ** (-order)
    probs /= probs.sum()
    toks = rng.choice(vocab_size, size=num_tokens, p=probs).astype(np.int32)
    # inject bigram structure: with prob .3, repeat the token 2 back
    mask = rng.uniform(size=num_tokens) < 0.3
    toks[2:][mask[2:]] = toks[:-2][mask[2:]]
    return toks
