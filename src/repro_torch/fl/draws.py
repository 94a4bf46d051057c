"""Draws providers: every random number a fleet round consumes.

A round takes, per seed row s of the fleet (and broadcasts over the K
schemes, as the reference does -- every scheme sees the same channel, noise
and minibatch stream, which is what makes the Fig.-2 comparison fair):

    h     [S, N]     complex64 fading, CN(0, gains)
    z     [S, D]     receiver noise N(0, 1), drawn leaf by leaf in raveling
                     order (b1, b2, w1, w2 for the MLP) and concatenated
    idx   [S, N, B]  minibatch indices, uniform with replacement
                     (None when the round is full batch)
    coin  [S]        the bbfl_alternative coin, True = full scheduling

The compute never sees a generator, only these tensors.  ``DeviceDraws``
is the production provider: one ``torch.Generator`` on the run's device,
seeded from (seed, round), so that a round's draws do not depend on the
rounds before it.  Torch cannot reproduce JAX's threefry streams, so the
parity tests replay the reference's own draws with ``ReplayDraws``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import ota

_MIX_SEED = 0x9E3779B97F4A7C15
_MIX_ROUND = 0xBF58476D1CE4E5B9
_SALT = 0x0A7F1D5E


class RoundDraws(NamedTuple):
    h: torch.Tensor
    z: torch.Tensor
    idx: Optional[torch.Tensor]
    coin: torch.Tensor


def round_seed(seed: int, t: int) -> int:
    """The generator seed of (seed, round t): a fixed 63-bit mix."""
    return (int(seed) * _MIX_SEED + int(t) * _MIX_ROUND + _SALT) % (1 << 63)


class DeviceDraws:
    """Production draws, generated on ``device`` from (seed, round)."""

    def __init__(self, seeds: Sequence[int], gains: np.ndarray,
                 leaf_sizes: Sequence[int], batch_size: int, shard_len: int,
                 device: torch.device):
        self.seeds = tuple(int(s) for s in seeds)
        self.gains = torch.as_tensor(np.asarray(gains, np.float32),
                                     device=device)
        self.leaf_sizes = tuple(int(v) for v in leaf_sizes)
        self.batch_size = int(batch_size)
        self.shard_len = int(shard_len)
        self.device = device
        self._gen = torch.Generator(device=device)

    def __call__(self, t: int) -> RoundDraws:
        n = self.gains.shape[0]
        hs, zs, idxs, coins = [], [], [], []
        gen = self._gen
        for seed in self.seeds:
            gen.manual_seed(round_seed(seed, t))
            hs.append(ota.draw_fading(self.gains, 1, gen)[0])
            zs.append(torch.cat([torch.randn(size, generator=gen,
                                             device=self.device)
                                 for size in self.leaf_sizes]))
            if self.batch_size:
                idxs.append(torch.randint(0, self.shard_len,
                                          (n, self.batch_size),
                                          generator=gen, device=self.device))
            coins.append(torch.rand((), generator=gen, device=self.device)
                         < 0.5)
        return RoundDraws(h=torch.stack(hs), z=torch.stack(zs),
                          idx=torch.stack(idxs) if idxs else None,
                          coin=torch.stack(coins))


class ReplayDraws:
    """Replays recorded draws: arrays with a leading round axis [T, S, ...]
    (``idx`` may be None for full-batch rounds), moved to ``device`` round
    by round."""

    def __init__(self, h: np.ndarray, z: np.ndarray, idx: Optional[np.ndarray],
                 coin: np.ndarray, device: torch.device):
        self.h, self.z, self.idx, self.coin = h, z, idx, coin
        self.device = device

    def __call__(self, t: int) -> RoundDraws:
        def dev(a, dtype=None):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=self.device)
        return RoundDraws(
            h=dev(self.h[t].astype(np.complex64)),
            z=dev(self.z[t], torch.float32),
            idx=None if self.idx is None else dev(self.idx[t], torch.int64),
            coin=dev(self.coin[t], torch.bool))
