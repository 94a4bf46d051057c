"""Mixture-of-Experts FFN of the port: top-k routing with sort-based
dispatch, a copy of ``repro.models.moe``.

The router runs in float32: softmax, the top k (lower expert first among
equal probabilities, as ``jax.lax.top_k``) and their weights normalized
to sum to 1, and the switch-style load-balance loss over each token's
first choice.  Each batch row is dispatched on its own, as the reference
vmaps over B: the row's S x K assignments, flattened s-major, are ranked
within their expert by token order (a stable sort), and those past the
expert's capacity (``expert_capacity``, from the row's S) are dropped.
The kept assignments fill [E, capacity] slots per row in the compute
dtype; the experts are two batched products, always SiLU-gated whatever
``ffn_kind`` says (as the reference's); the combine adds a token's K
weighted outputs one at a time in the compute dtype, as the reference's
scatter-add does.  Shared experts (DeepSeek) are a dense MLP over every
token.  The reference has no Pallas kernel here: this is plain PyTorch on
every device, gathers and batched GEMMs, with no scatter-add (its CUDA
form sums with atomics, in no fixed order).

``moe_apply`` is ``route`` then ``experts``, split so that tests can
hand the second half the reference's own routes.
"""
from __future__ import annotations

import collections
import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import mlp, mlp_def
from repro_torch.models.param import P, ParamDef, divisible


def expert_capacity(cfg: ModelConfig, seq: int) -> int:
    """Slots per expert for one batch row of ``seq`` tokens: a multiple
    of 4, at least 4."""
    cap = math.ceil(cfg.moe_top_k * seq * cfg.capacity_factor
                    / cfg.moe_num_experts)
    return max(4, ((cap + 3) // 4) * 4)


def moe_def(cfg: ModelConfig, tp: int = 16, dp: int = 16) -> dict:
    """``router`` [D, E] in float32; ``wi`` [E, D, 2, F] (gate and up, as
    the dense MLP's) and ``wo`` [E, F, D] in the param dtype; ``shared``,
    a dense MLP of width ``expert_d_ff * moe_shared_experts``, when the
    config has shared experts.  The experts over 'data' where E divides
    ``dp`` (else D), F over 'model'."""
    e, d, f = cfg.moe_num_experts, cfg.d_model, cfg.expert_d_ff
    e_ax = "data" if divisible(e, dp) else None
    d_ax = None if e_ax == "data" else ("data" if divisible(d, dp) else None)
    f_ax = "model" if divisible(f, tp) else None
    defs = {
        "router": ParamDef((d, e), init="scaled", fan_in=d,
                           dtype=torch.float32, spec=P(None, None)),
        "wi": ParamDef((e, d, 2, f), init="scaled", fan_in=d,
                       dtype=cfg.param_dtype, spec=P(e_ax, d_ax, None, f_ax)),
        "wo": ParamDef((e, f, d), init="scaled", fan_in=f,
                       dtype=cfg.param_dtype, spec=P(e_ax, f_ax, d_ax)),
    }
    if cfg.moe_shared_experts:
        defs["shared"] = mlp_def(cfg, d_ff=cfg.expert_d_ff
                                 * cfg.moe_shared_experts, tp=tp)
    return defs


def _dispatch_indices(expert_id: torch.Tensor, capacity: int,
                      num_experts: int):
    """expert_id: [..., A] assignments, each row on its own.  Returns
    (slot, keep), both [..., A]: slot = expert * capacity + the rank of
    the assignment within its expert by position (a stable sort), or the
    dump slot ``num_experts * capacity`` where that rank reaches the
    capacity (keep False)."""
    a = expert_id.shape[-1]
    order = torch.argsort(expert_id, dim=-1, stable=True)
    sorted_eid = torch.gather(expert_id, -1, order)
    first = torch.searchsorted(sorted_eid, sorted_eid, side="left")
    rank_sorted = torch.arange(a, device=expert_id.device) - first
    rank = torch.empty_like(rank_sorted).scatter_(-1, order, rank_sorted)
    keep = rank < capacity
    slot = torch.where(keep, expert_id * capacity + rank,
                       num_experts * capacity)
    return slot, keep


def route(p, x: torch.Tensor, cfg: ModelConfig):
    """x: [B, S, D] -> (probs [B, S, E], top_w [B, S, K], top_e [B, S, K],
    aux): the router in float32, the top k by a stable descending sort
    (``torch.topk`` does not promise the lower index first among equal
    values), their weights normalized, and the switch load-balance loss
    E * sum_e (share of tokens whose first choice is e) * (mean prob of
    e)."""
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[..., :k], top_e[..., :k]
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)
    frac_tokens = torch.mean(F.one_hot(top_e[..., 0], e).float(), dim=(0, 1))
    mean_probs = torch.mean(probs, dim=(0, 1))
    aux = e * torch.sum(frac_tokens * mean_probs)
    return probs, top_w, top_e, aux


def experts(p, x: torch.Tensor, top_w: torch.Tensor, top_e: torch.Tensor,
            cfg: ModelConfig):
    """x: [B, S, D], a route's top_w and top_e [B, S, K] -> (y [B, S, D]
    in x's dtype, slot [B, S*K], keep [B, S*K]): ``_dispatch_indices`` per
    row, the experts over their kept slots, the weighted combine, plus the
    shared experts.  Counts the call and records its kept assignments
    (``experts.calls``, ``experts.kept``: (kept, all) per call, the first
    a device scalar, read without a sync)."""
    b, s, d = x.shape
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    cap = expert_capacity(cfg, s)
    ct = cfg.compute_dtype
    dev = x.device
    a = s * k
    slot, keep = _dispatch_indices(top_e.reshape(b, a), cap, e)
    experts.calls += 1
    experts.kept.append((keep.sum(), keep.numel()))

    # dispatch: the assignment that fills each slot (kept slots are
    # unique; a dropped assignment writes a slot of its own past the end),
    # then the token rows gathered in [E, B x capacity] order
    own = e * cap + torch.arange(a, device=dev)
    src = torch.full((b, e * cap + a), a, dtype=torch.long, device=dev)
    src.scatter_(1, torch.where(keep, slot, own),
                 torch.arange(a, device=dev).expand(b, a))
    src = src[:, :e * cap]
    rows = torch.arange(b, device=dev)[:, None]
    tok = torch.where(src < a, rows * s + src // k, b * s)   # b*s: zeros
    tok = tok.reshape(b, e, cap).transpose(0, 1).reshape(e, b * cap)
    xs = torch.cat([x.reshape(b * s, d).to(ct), x.new_zeros((1, d), dtype=ct)])
    ein = xs[tok]                                           # [E, B*cap, D]

    wi = p["wi"].to(ct)                                     # [E, D, 2, F]
    h2 = torch.bmm(ein, wi.reshape(e, d, -1)).unflatten(-1, wi.shape[2:])
    h = F.silu(h2[..., 0, :]) * h2[..., 1, :]
    eout = torch.bmm(h, p["wo"].to(ct))                     # [E, B*cap, D]

    # combine: slot = expert * cap + rank -> row (expert, b, rank) of eout
    at = (slot // cap) * (b * cap) + rows * cap + slot % cap
    out = eout.reshape(e * b * cap, d)[torch.where(keep, at, 0)]
    contrib = torch.where(keep[..., None],
                          out * top_w.reshape(b, a, 1).to(ct), 0)
    contrib = contrib.reshape(b, s, k, d)
    y = torch.zeros((b, s, d), dtype=ct, device=dev)
    for j in range(k):                  # one rounding per term, in ct
        y = y + contrib[:, :, j]
    if cfg.moe_shared_experts:
        y = y + mlp(p["shared"], x, cfg)
    return y.to(x.dtype), slot, keep


experts.calls = 0
experts.kept = collections.deque(maxlen=4096)


def kept_and_dropped() -> list:
    """(kept, dropped) assignments of each ``experts`` call recorded since
    ``experts.kept`` was last cleared, oldest first (syncs the device)."""
    return [(int(n), total - int(n)) for n, total in experts.kept]


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig):
    """x: [B, S, D] -> (y [B, S, D], aux scalar float32)."""
    _, top_w, top_e, aux = route(p, x, cfg)
    y, _, _ = experts(p, x, top_w, top_e, cfg)
    return y, aux
