"""Step functions: the OTA-FL train step, prefill and one greedy decode
step, ported from ``repro.launch.steps``.

The train step implements the paper's update (7) in the reference's
weighted-loss form: the FL clients are slices of the global batch; the
round's fading draws the coefficients s_m = chi_{m,t} gamma_m / alpha from
the bound scheme; the client-weighted loss (w_m = N s_m) makes the one
gradient of the batch the OTA superposition sum_m s_m grad f_m; receiver
noise is added to it leaf by leaf in the leaf's dtype; the PS update is
plain SGD in float32, cast back to the parameter's dtype.

A batch is a token tensor [gb, S + 1] or, for an encoder-decoder, the
pair (frames [gb, S_frames, D], tokens [gb, S + 1]) of the reference's
``input_specs``: the client ids, gb and the device come from the tokens,
and the pair goes whole to the bundle's loss.

Random draws are inputs (``StepDraws``): the fading h [N], the scheme's
coin (bbfl_alternative) and one float32 z per leaf.  ``DeviceStepDraws``
is the production provider, a generator on the device keyed per (seed,
step); the parity tests replay the reference's own draws.  The loss is
differentiated through the plain attention and SSD scan
(``use_kernel=False``), as the reference trains through its jnp forms; K3
and K4 have no backward (ROADMAP.md).  PyTorch runs eagerly, so the steps
are plain closures over the bundle (the reference ``jax.jit``s them), and
the train step updates the parameters in place (the reference donates
them).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import ota
from repro_torch.core.power_control import PowerControl
from repro_torch.fl.draws import round_seed
from repro_torch.models.param import param_leaves, trainable
from repro_torch.models.registry import ModelBundle

_STEP_SALT = 0x17A1C0DE


@dataclasses.dataclass
class TrainStepConfig:
    eta: float = 1e-2
    optimizer: str = "sgd"          # paper: plain SGD (eq. 7), the only one
                                    # the reference's train step applies


class StepDraws(NamedTuple):
    """One train step's random inputs."""
    h: torch.Tensor        # [N] complex64 fading
    coin: torch.Tensor     # [] bool: bbfl_alternative's full-scheduling coin
    z: dict                # leaf name -> float32 noise of the leaf's shape


class DeviceStepDraws:
    """Production draws on ``device`` from (seed, step): one generator,
    reseeded per step, so a step's draws do not depend on the steps before
    it.  h is CN(0, gains) from two normals per client, as the fleet's
    ``DeviceDraws``; then the coin; then z leaf by leaf in ``shapes``'s
    order (name -> shape)."""

    def __init__(self, seed: int, gains: np.ndarray, shapes: dict,
                 device: torch.device):
        self.seed = int(seed)
        self.scale = torch.as_tensor(ota.fading_scales(gains)[0],
                                     device=device)
        self.shapes = {k: tuple(v) for k, v in shapes.items()}
        self.device = device
        self._gen = torch.Generator(device=device)

    def __call__(self, t: int) -> StepDraws:
        gen, dev = self._gen, self.device
        gen.manual_seed(round_seed(self.seed, t, _STEP_SALT))
        re, im = ota.draw_normals(tuple(self.scale.shape), gen, dev)
        h = ota.gaussian_fading(re, im, self.scale)
        coin = torch.rand((), generator=gen, device=dev) < 0.5
        z = {k: torch.randn(shape, generator=gen, device=dev)
             for k, shape in self.shapes.items()}
        return StepDraws(h=h, coin=coin, z=z)


def _value_and_grad(loss_fn, params):
    """(loss, {leaf name: gradient}) of ``loss_fn(view)`` over a trainable
    view of ``params``, which shares their storage."""
    view, leaves = trainable(params)
    with torch.enable_grad():
        loss = loss_fn(view)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


@torch.no_grad()
def _sgd_in_place(params, grads: dict, eta: float) -> None:
    for name, p in param_leaves(params).items():
        p.copy_((p.float() - eta * grads[name].float()).to(p.dtype))


def _check_sgd(tcfg: TrainStepConfig) -> None:
    if tcfg.optimizer != "sgd":
        raise ValueError(f"optimizer {tcfg.optimizer!r}: the train step "
                         "applies the paper's SGD only, as the reference's")


def batch_tokens(batch) -> torch.Tensor:
    """The tokens [gb, S + 1] of a batch: the tensor itself, or the second
    of an encoder-decoder's (frames, tokens), whose frames must share
    their batch axis."""
    if not isinstance(batch, tuple):
        return batch
    frames, tokens = batch
    if frames.shape[0] != tokens.shape[0]:
        raise ValueError(f"frames {tuple(frames.shape)} and tokens "
                         f"{tuple(tokens.shape)} differ in their batch axis")
    return tokens


def make_train_step(bundle: ModelBundle, scheme: PowerControl,
                    gains: np.ndarray, tcfg: TrainStepConfig):
    """(params, batch, draws) -> (params, metrics); params are updated in
    place.  ``batch`` is tokens [gb, S + 1] or (frames, tokens).  gb must
    be a multiple of the number of clients: sample b belongs to client
    b // (gb // N)."""
    _check_sgd(tcfg)
    n_clients = int(np.shape(gains)[0])

    def train_step(params, batch, draws: StepDraws):
        tokens = batch_tokens(batch)
        s, noise_scale = scheme.round_coeffs(draws.h[None],
                                             draws.coin.reshape(1))
        s, noise_scale = s[0], noise_scale[0]
        w = ota.per_client_loss_weights(s)                  # [N]
        gb = tokens.shape[0]
        client_ids = torch.arange(gb, device=tokens.device) \
            // (gb // n_clients)
        sample_w = w[client_ids]

        loss, grads = _value_and_grad(
            lambda view: bundle.loss(view, batch, sample_w), params)
        grads = ota.add_receiver_noise_leaves(grads, noise_scale, draws.z)
        _sgd_in_place(params, grads, tcfg.eta)
        metrics = {"loss": loss,
                   "active_clients": torch.sum((s > 0).float()),
                   "noise_scale": noise_scale.float()}
        return params, metrics

    return train_step


def make_ideal_train_step(bundle: ModelBundle, tcfg: TrainStepConfig):
    """Noiseless FedAvg reference (eq. (2)), also the plain-SGD baseline:
    (params, batch, draws=None) -> (params, {"loss"}), in place; ``batch``
    as ``make_train_step``'s."""
    _check_sgd(tcfg)

    def train_step(params, batch, draws=None):
        batch_tokens(batch)
        loss, grads = _value_and_grad(lambda view: bundle.loss(view, batch),
                                      params)
        _sgd_in_place(params, grads, tcfg.eta)
        return params, {"loss": loss}

    return train_step


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------

def make_prefill_step(bundle: ModelBundle):
    def prefill_step(params, inputs, caches):
        return bundle.prefill(params, inputs, caches)
    return prefill_step


def make_serve_step(bundle: ModelBundle):
    """One decode step: token [B, 1] against the KV caches (updated in
    place); returns the greedy next token [B, 1] and the caches."""
    def serve_step(params, caches, token, pos: int):
        logits, caches = bundle.decode(params, caches, token, pos)
        next_token = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        return next_token, caches
    return serve_step
