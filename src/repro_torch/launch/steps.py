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

On a mesh of ranks (module 12b; ``launch.mesh.ShardMesh``): the sharding
helpers of the reference (``named``, ``param_shardings``, ``batch_spec``,
``cache_shardings``, the shardings half of ``input_specs``) give each
parameter, cache leaf and input its spec and DTensor placements;
``shard_params`` and ``shard_caches`` lay a ParamTree and the caches out
by them.  ``make_train_step(..., mesh=)`` is the reference's pjit step:
its FL clients are the batch slices over ``batch_axes(mesh)`` (N =
``num_clients(mesh)``), the weighted loss's gradient is reduced over
those axes (the OTA superposition sum_m s_m g_m), the receiver noise is
added once after the reduction, the same z on every rank (each its
shard), and SGD updates each parameter's own shards.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import distributed as dist
from repro_torch.core import ota
from repro_torch.core.power_control import PowerControl
from repro_torch.fl.draws import round_seed
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.param import (P, ParamTree, map_named, param_leaves,
                                      param_specs, trainable)
from repro_torch.models.registry import ModelBundle


# ---------------------------------------------------------------------------
# Sharding helpers
# ---------------------------------------------------------------------------

def _filter_spec(spec, mesh) -> P:
    axes = []
    for ax in spec:
        if ax is None:
            axes.append(None)
        elif isinstance(ax, (tuple, list)):
            keep = tuple(a for a in ax if a in mesh.axis_names)
            axes.append(keep if keep else None)
        else:
            axes.append(ax if ax in mesh.axis_names else None)
    return P(*axes)


def named(mesh, spec) -> tuple:
    """The DTensor placements over ``mesh`` of ``spec`` (its axes that the
    mesh has): the reference's ``NamedSharding``."""
    return dist.placements(mesh, _filter_spec(spec, mesh))


def param_shardings(bundle: ModelBundle, mesh):
    """The placements of every parameter, in the defs' layout."""
    from repro_torch.models.param import _map_defs
    return _map_defs(bundle.defs, lambda d: named(mesh, d.spec))


def batch_spec(mesh, global_batch: int, extra_dims: int = 1) -> P:
    axes = mesh_lib.batch_axes(mesh)
    total = 1
    for a in axes:
        total *= mesh.shape[a]
    lead = axes if global_batch % total == 0 else None
    return P(lead, *([None] * extra_dims))


# cache sharding rules, keyed on leaf name (``models.*.init_*_cache``)
_CACHE_BASE_NDIM = {"k": 4, "v": 4, "ckv": 3, "krope": 3,
                    "ssm": 4, "conv": 3, "h": 2}


def _cache_leaf_spec(name: str, shape: tuple, mesh, batch_div: bool) -> P:
    base = _CACHE_BASE_NDIM[name]
    extra = len(shape) - base          # stacked layer axes (scan groups)
    core = shape[extra:]
    m = mesh.shape.get("model", 1)
    d = mesh.shape.get("data", 1)
    baxes = mesh_lib.batch_axes(mesh)
    b_ax = baxes if batch_div else None
    if name in ("k", "v"):
        b, s, kh, dh = core
        seq_ax = "data" if (not batch_div and s % d == 0) else None
        head_ax = "model" if kh % m == 0 else None
        spec = (b_ax, seq_ax, head_ax, None)
    elif name in ("ckv", "krope"):
        b, s, r = core
        seq_ax = "data" if (not batch_div and s % d == 0) else None
        spec = (b_ax, seq_ax, "model" if r % m == 0 else None)
    elif name == "ssm":
        b, h, pd, n = core
        spec = (b_ax, "model" if h % m == 0 else None, None, None)
    elif name == "conv":
        b, k, c = core
        spec = (b_ax, None, "model" if c % m == 0 else None)
    else:  # "h"
        b, w = core
        spec = (b_ax, "model" if w % m == 0 else None)
    return P(*([None] * extra + list(spec)))


def _batch_div(mesh, global_batch: int) -> bool:
    total = 1
    for a in mesh_lib.batch_axes(mesh):
        total *= mesh.shape[a]
    return global_batch % total == 0


def cache_shardings(caches, mesh, global_batch: int):
    """The placements of every cache leaf, in the caches' layout (per
    layer dicts keyed by leaf name; the encoder-decoder's (self, cross)
    pair)."""
    div = _batch_div(mesh, global_batch)

    def leaf(path, x):
        name = path.rsplit(".", 1)[-1]
        if name not in _CACHE_BASE_NDIM:
            raise ValueError(f"unrecognized cache leaf at {path}")
        return named(mesh, _cache_leaf_spec(name, tuple(x.shape), mesh, div))
    return map_named(caches, leaf)


def shard_params(params, defs, mesh) -> ParamTree:
    """``params`` (a ParamTree of whole tensors, each rank's the same) as a
    ParamTree of DTensors laid out by the specs of ``defs`` (their def
    tree, or a ModelBundle's) on ``mesh``: each rank keeps its shard, and
    nothing is sent (``distributed.distribute``; a copy: the step's
    in-place updates leave ``params`` as they were; under
    ``LocalTensorMode`` each rank's copy of its shard alone)."""
    specs = param_specs(getattr(defs, "defs", defs))

    def one(path, t):
        spec = specs
        for key in path.split("."):
            spec = spec[int(key)] if isinstance(spec, list) else spec[key]
        src = t.detach() if dist.local_mode() is not None \
            else t.detach().clone()
        return dist.distribute(src, mesh, named(mesh, spec))
    return ParamTree(map_named(params, one))


def shard_caches(caches, mesh, global_batch: int):
    """Caches of whole tensors as DTensors laid out by
    ``cache_shardings``, in the same layout."""
    pl = cache_shardings(caches, mesh, global_batch)

    def one(path, t):
        spec = pl
        for key in path.split("."):
            spec = spec[int(key)] if isinstance(spec, list) else spec[key]
        return dist.distribute(t, mesh, spec)
    return map_named(caches, one)


def input_shardings(bundle: ModelBundle, shape, mesh) -> dict:
    """The shardings half of the reference's ``input_specs``: the
    placements of a step's inputs for ``shape``'s kind ("tokens", the
    decoder's "frames" or "dec_tokens", "token", "pos", "key", "caches",
    "cross_caches")."""
    cfg = bundle.cfg
    gb, s = shape.global_batch, shape.seq_len
    b1 = named(mesh, batch_spec(mesh, gb, 1))
    b2 = named(mesh, batch_spec(mesh, gb, 2))
    rep = named(mesh, P())
    if shape.kind == "train":
        out = {"tokens": b1, "key": rep}
        if cfg.is_enc_dec:
            out["frames"] = b2
        return out
    if shape.kind == "prefill":
        out = {"tokens": b1, "caches": cache_shardings(
            _abstract_caches(bundle, gb, s), mesh, gb)}
        if cfg.is_enc_dec:
            out["frames"] = b2
        return out
    if shape.kind == "decode":
        out = {"caches": cache_shardings(_abstract_caches(bundle, gb, s),
                                         mesh, gb),
               "token": b1, "pos": rep}
        if cfg.is_enc_dec:
            dh = cfg.resolved_head_dim
            kv = torch.empty((gb, s, cfg.n_kv_heads, dh), device="meta")
            out["cross_caches"] = cache_shardings(
                [{"k": kv, "v": kv}] * cfg.n_layers, mesh, gb)
        return out
    raise ValueError(shape.kind)


def _abstract_caches(bundle: ModelBundle, gb: int, s: int):
    """The caches' shapes, on the meta device (nothing allocated)."""
    from repro_torch.models import encdec, transformer
    cfg, dev = bundle.cfg, torch.device("meta")
    if cfg.is_enc_dec:
        return encdec.init_decode_caches(cfg, gb, s, dev)
    return transformer.init_caches(cfg, gb, s, dev)

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


@torch.no_grad()
def _sharded_update(params, grads: dict, eta: float, noise_scale=None,
                    z: Optional[dict] = None) -> None:
    """The SGD step on a mesh, on each parameter's own shards: its
    gradient reduced to the parameter's placements (over the batch axes:
    the OTA superposition), plus ``noise_scale * z`` when given -- z whole
    and the same on every rank, each taking its shard, so the noise is
    added once, after the reduction."""
    from torch.distributed.tensor import distribute_tensor
    for name, p in param_leaves(params).items():
        g = grads[name]
        if tuple(g.placements) != tuple(p.placements):
            g = g.redistribute(p.device_mesh, p.placements)
        g = g.to_local()
        if z is not None:
            zl = z[name].to_local() if dist.is_dtensor(z[name]) else \
                distribute_tensor(z[name], p.device_mesh, p.placements,
                                  src_data_rank=None).to_local()
            g = g + (noise_scale * zl).to(g.dtype)
        pl = p.to_local()
        pl.copy_((pl.float() - eta * g.float()).to(pl.dtype))


def _scalar(t):
    """A replicated scalar DTensor's value as a plain tensor."""
    return t.to_local() if dist.is_dtensor(t) else t


def _bound(mesh):
    return dist.mesh_rules(mesh) if mesh is not None \
        else contextlib.nullcontext()


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
                    gains: np.ndarray, tcfg: TrainStepConfig, mesh=None):
    """(params, batch, draws) -> (params, metrics); params are updated in
    place.  ``batch`` is tokens [gb, S + 1] or (frames, tokens).  gb must
    be a multiple of the number of clients: sample b belongs to client
    b // (gb // N).  With ``mesh`` (params from ``shard_params``), the
    step on the mesh: N = ``num_clients(mesh)``, client m the m-th batch
    slice over the batch axes (see the module's docstring)."""
    _check_sgd(tcfg)
    n_clients = int(np.shape(gains)[0])
    if mesh is not None and n_clients != mesh_lib.num_clients(mesh):
        raise ValueError(f"{n_clients} clients' gains on a mesh of "
                         f"{mesh_lib.num_clients(mesh)} batch slices")

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

        with _bound(mesh):
            loss, grads = _value_and_grad(
                lambda view: bundle.loss(view, batch, sample_w), params)
            if mesh is None:
                grads = ota.add_receiver_noise_leaves(grads, noise_scale,
                                                      draws.z)
                _sgd_in_place(params, grads, tcfg.eta)
            else:
                _sharded_update(params, grads, tcfg.eta, noise_scale,
                                draws.z)
        metrics = {"loss": _scalar(loss),
                   "active_clients": torch.sum((s > 0).float()),
                   "noise_scale": noise_scale.float()}
        return params, metrics

    return train_step


def make_ideal_train_step(bundle: ModelBundle, tcfg: TrainStepConfig,
                          mesh=None):
    """Noiseless FedAvg reference (eq. (2)), also the plain-SGD baseline:
    (params, batch, draws=None) -> (params, {"loss"}), in place; ``batch``
    and ``mesh`` as ``make_train_step``'s."""
    _check_sgd(tcfg)

    def train_step(params, batch, draws=None):
        batch_tokens(batch)
        with _bound(mesh):
            loss, grads = _value_and_grad(
                lambda view: bundle.loss(view, batch), params)
            if mesh is None:
                _sgd_in_place(params, grads, tcfg.eta)
            else:
                _sharded_update(params, grads, tcfg.eta)
        return params, {"loss": _scalar(loss)}

    return train_step


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------

def make_prefill_step(bundle: ModelBundle, mesh=None):
    """(params, inputs, caches) -> (logits, caches); with ``mesh``, on the
    mesh (params and caches from ``shard_params`` / ``shard_caches``;
    logits a DTensor, the vocab over "model")."""
    def prefill_step(params, inputs, caches):
        with _bound(mesh):
            return bundle.prefill(params, inputs, caches)
    return prefill_step


def make_serve_step(bundle: ModelBundle, mesh=None):
    """One decode step: token [B, 1] against the KV caches (updated in
    place); returns the greedy next token [B, 1] and the caches.  With
    ``mesh``, on the mesh: the last position's logits are gathered over
    the vocab first, and the token comes back over the batch axes."""
    def serve_step(params, caches, token, pos: int):
        with _bound(mesh):
            logits, caches = bundle.decode(params, caches, token, pos)
            last = logits[:, -1, :]
            if not dist.is_dtensor(last):
                return torch.argmax(last, dim=-1)[:, None], caches
            from torch.distributed.tensor import DTensor
            bspec = batch_spec(mesh, last.shape[0], 1)
            last = last.redistribute(mesh.device_mesh, named(mesh, bspec))
            nxt = torch.argmax(last.to_local(), dim=-1)[:, None]
            return DTensor.from_local(nxt, mesh.device_mesh,
                                      named(mesh, bspec),
                                      run_check=False), caches
    return serve_step
