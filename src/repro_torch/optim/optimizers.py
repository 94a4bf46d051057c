"""Optimizers over dicts of tensors, ported from ``repro.optim.optimizers``.

The paper's method is plain SGD (eq. (7)); momentum and AdamW are there for
the non-paper training paths.  The API mirrors optax's: ``(init, update)``,
where ``update(grads, state, params, lr_now=None)`` returns ``(new_params,
new_state)``.  Trees are dicts by leaf name (the train step's leaves);
state is float32, and params are updated in float32 and cast back to their
dtype, as the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[dict], object]
    update: Callable[..., tuple]     # (grads, state, params, lr?) -> (params, state)
    name: str = "opt"


def _zeros_like_f32(params: dict) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params, lr_now: Optional[float] = None):
        step = lr_now if lr_now is not None else lr
        new = {k: (p.float() - step * grads[k].float()).to(p.dtype)
               for k, p in params.items()}
        return new, state

    return Optimizer(init, update, "sgd")


def sgd_momentum(lr: float, beta: float = 0.9) -> Optimizer:
    def init(params):
        return _zeros_like_f32(params)

    def update(grads, state, params, lr_now: Optional[float] = None):
        step = lr_now if lr_now is not None else lr
        new_m = {k: beta * m + grads[k].float() for k, m in state.items()}
        new_p = {k: (p.float() - step * new_m[k]).to(p.dtype)
                 for k, p in params.items()}
        return new_p, new_m

    return Optimizer(init, update, "sgd_momentum")


class AdamState(NamedTuple):
    mu: dict
    nu: dict
    count: torch.Tensor


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        dev = next(iter(params.values())).device if params else None
        return AdamState(_zeros_like_f32(params), _zeros_like_f32(params),
                         torch.zeros((), dtype=torch.int32, device=dev))

    def update(grads, state, params, lr_now: Optional[float] = None):
        step = lr_now if lr_now is not None else lr
        cnt = state.count + 1
        mu = {k: b1 * m + (1 - b1) * grads[k].float()
              for k, m in state.mu.items()}
        nu = {k: b2 * v + (1 - b2) * torch.square(grads[k].float())
              for k, v in state.nu.items()}
        bc1 = 1 - b1 ** cnt.float()
        bc2 = 1 - b2 ** cnt.float()

        def upd(p, m, v):
            mhat = m / bc1
            vhat = v / bc2
            delta = mhat / (torch.sqrt(vhat) + eps)
            if weight_decay:
                delta = delta + weight_decay * p.float()
            return (p.float() - step * delta).to(p.dtype)

        new = {k: upd(p, mu[k], nu[k]) for k, p in params.items()}
        return new, AdamState(mu, nu, cnt)

    return Optimizer(init, update, "adamw")


def clip_by_global_norm(grads: dict, max_norm: float):
    """Scale grads so that the global l2 norm is <= max_norm.

    Enforces Assumption 2 (||g_m|| <= G_max).  The norm is taken over all
    leaves in float32, in raveling order; scale = min(1, max_norm /
    max(norm, 1e-12)).  Returns (clipped grads, pre-clip norm).
    """
    sq = sum(torch.sum(torch.square(grads[k].float())) for k in sorted(grads))
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: (g * scale).to(g.dtype) for k, g in grads.items()}, norm


def get_optimizer(name: str, lr: float, **kw) -> Optimizer:
    if name == "sgd":
        return sgd(lr)
    if name == "sgd_momentum":
        return sgd_momentum(lr, **kw)
    if name == "adamw":
        return adamw(lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
