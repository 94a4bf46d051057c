"""Draws providers: every random number a fleet round consumes.

A round takes, per seed row s of the fleet (and broadcasts over the K
schemes, as the reference does -- every scheme sees the same channel, noise
and minibatch stream, which is what makes the Fig.-2 comparison fair):

    h     [S, N]     complex64 fading, CN(0, gains) (``RoundDraws``)
    fade  Innovations  on a fleet with a fading process or a scenario
                     stack (``FadingDraws``): the scattered normals [S, N],
                     and, when a row needs them, the dropout uniforms and
                     Nakagami's Gamma inputs; the process turns them into
                     h.  They are shared by every scenario row and scheme
                     of a seed, as the reference tiles one key over them
    z     [S, D]     receiver noise N(0, 1), drawn leaf by leaf in raveling
                     order (b1, b2, w1, w2 for the MLP) and concatenated
    idx   [S, N, B]  minibatch indices, uniform with replacement
                     (None when the round is full batch)
    coin  [S]        the bbfl_alternative coin, True = full scheduling

The compute never sees a generator, only these tensors.  ``DeviceDraws``
is the production provider: one ``torch.Generator`` on the run's device,
seeded from (seed, round), so that a round's draws do not depend on the
rounds before it.  The scattered normals are the very numbers the paper's
path turns into h, so an i.i.d. Rayleigh process is bitwise that path; the
dropout uniforms and the Nakagami inputs come from streams of their own,
salted, so a row's numbers do not depend on which other rows a grid holds.
The fading state starts from a separate salted stream per seed
(``init_seed``), as the reference's ``FADING_INIT_SALT``.  Torch cannot
reproduce JAX's threefry streams, so the parity tests replay the
reference's own draws with ``ReplayDraws``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import ota

_MIX_SEED = 0x9E3779B97F4A7C15
_MIX_ROUND = 0xBF58476D1CE4E5B9
_SALT = 0x0A7F1D5E
_DROP_SALT = 0x0D50A7E1
_GAMMA_SALT = 0x6A77A5ED
_INIT_SALT = 0x5CE7A810       # the reference's FADING_INIT_SALT


class RoundDraws(NamedTuple):
    h: torch.Tensor
    z: torch.Tensor
    idx: Optional[torch.Tensor]
    coin: torch.Tensor


class FadingDraws(NamedTuple):
    """A round of a fleet whose channel is a fading process: its
    innovations take the place of h."""
    fade: ota.Innovations
    z: torch.Tensor
    idx: Optional[torch.Tensor]
    coin: torch.Tensor


def round_seed(seed: int, t: int, salt: int = _SALT) -> int:
    """The generator seed of (seed, round t): a fixed 63-bit mix."""
    return (int(seed) * _MIX_SEED + int(t) * _MIX_ROUND + salt) % (1 << 63)


def init_seed(seed: int) -> int:
    """The generator seed of a seed row's initial fading state."""
    return round_seed(seed, 0, _INIT_SALT)


class DeviceDraws:
    """Production draws, generated on ``device`` from (seed, round).
    ``fading`` (a ``FadingProcess`` or ``ScenarioStack``; ``gains`` may
    then be None) makes the rounds ``FadingDraws`` with the innovations
    its rows need.  In population mode the i.i.d. channel's scale changes
    with every cohort: ``set_scale`` takes the chunk's [S, N] scales, one
    row per seed (the keys stay (seed, round), as the reference's cohort
    round splits its key as its plain round does)."""

    def __init__(self, seeds: Sequence[int], gains: Optional[np.ndarray],
                 leaf_sizes: Sequence[int], batch_size: int, shard_len: int,
                 device: torch.device, fading=None):
        self.seeds = tuple(int(s) for s in seeds)
        self.scale = None if gains is None else torch.as_tensor(
            ota.fading_scales(gains)[0], device=device)
        self.num_devices = int(np.shape(gains)[-1]) if gains is not None \
            else int(np.shape(fading.gains)[-1])
        self.leaf_sizes = tuple(int(v) for v in leaf_sizes)
        self.batch_size = int(batch_size)
        self.shard_len = int(shard_len)
        self.device = device
        self.fading = fading
        self._gen = torch.Generator(device=device)

    def set_scale(self, scale: torch.Tensor) -> None:
        """The i.i.d. channel's scale sqrt(Lambda / 2): [N], or [S, N] with
        row s for seed row s (a population's cohorts)."""
        self.scale = scale

    def init(self) -> ota.Innovations:
        """The innovations of the initial fading state: [S, N] normals."""
        gen, n_re, n_im = self._gen, [], []
        for seed in self.seeds:
            gen.manual_seed(init_seed(seed))
            re, im = ota.draw_normals((self.num_devices,), gen, self.device)
            n_re.append(re), n_im.append(im)
        return ota.Innovations(torch.stack(n_re), torch.stack(n_im))

    def __call__(self, t: int):
        n, dev, fading = self.num_devices, self.device, self.fading
        hs, n_re, n_im, zs, idxs, coins, drops, gammas = ([] for _ in
                                                          range(8))
        gen = self._gen
        for row, seed in enumerate(self.seeds):
            gen.manual_seed(round_seed(seed, t))
            re, im = ota.draw_normals((n,), gen, dev)
            if fading is None:
                scale = self.scale if self.scale.dim() == 1 \
                    else self.scale[row]
                hs.append(ota.gaussian_fading(re, im, scale))
            else:
                n_re.append(re), n_im.append(im)
            zs.append(torch.cat([torch.randn(size, generator=gen,
                                             device=dev)
                                 for size in self.leaf_sizes]))
            if self.batch_size:
                idxs.append(torch.randint(0, self.shard_len,
                                          (n, self.batch_size),
                                          generator=gen, device=dev))
            coins.append(torch.rand((), generator=gen, device=dev) < 0.5)
            if fading is not None and fading.needs_dropout:
                gen.manual_seed(round_seed(seed, t, _DROP_SALT))
                drops.append(torch.rand(n, generator=gen, device=dev))
            if fading is not None and fading.needs_nakagami:
                gen.manual_seed(round_seed(seed, t, _GAMMA_SALT))
                gammas.append(ota.draw_gamma_inputs((n,), gen, dev))
        z = torch.stack(zs)
        idx = torch.stack(idxs) if idxs else None
        coin = torch.stack(coins)
        if fading is None:
            return RoundDraws(h=torch.stack(hs), z=z, idx=idx, coin=coin)
        gam = [None] * 4
        if gammas:
            gn, gu, bu, pu = zip(*gammas)
            gam = [torch.stack(gn, 1), torch.stack(gu, 1), torch.stack(bu),
                   torch.stack(pu)]
        fade = ota.Innovations(torch.stack(n_re), torch.stack(n_im),
                               torch.stack(drops) if drops else None, *gam)
        return FadingDraws(fade=fade, z=z, idx=idx, coin=coin)


class ReplayDraws:
    """Replays recorded draws: arrays with a leading round axis [T, S, ...]
    (``idx`` may be None for full-batch rounds), moved to ``device`` round
    by round.  ``h`` may carry a scenario-row axis, [T, R, S, N]: the
    reference's per-row channel of a fading process or a scenario grid,
    which the round then takes as it is."""

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
