"""RG-LRU recurrent block of the port (RecurrentGemma / Griffin,
arXiv:2402.19427).

A copy of ``repro.models.rglru``.  The Real-Gated Linear Recurrent Unit:

    r_t = sigmoid(W_a x_t + b_a)          recurrence gate
    i_t = sigmoid(W_x x_t + b_x)          input gate
    a_t = exp(c * r_t * log sigmoid(lam))  per-channel learned decay, c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The block (Griffin's recurrent block): two input linears (a branch and a
GELU gate), a short causal conv on the branch, the RG-LRU, a
multiplicative merge and an output linear.  The casts are the
reference's: the linears in the compute dtype, the conv, the gates and
the recurrence in float32 (``lam`` is a float32 leaf at every width).

A prefill's recurrence is a log-depth doubling scan over the (a, b) pairs
(``_lru_scan``), the reference's ``associative_scan`` in PyTorch; its
combine order differs, so it agrees with the reference to f32 rounding,
not bit for bit.  A decode step is one update against the state.  The
reference has no Pallas kernel for the block, so the port has no CUDA
kernel for it either (ROADMAP.md queues one).  The state is written in
place (the reference returns a new one).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.param import P, ParamDef, divisible

C_FACTOR = 8.0
CONV_K = 4


def _width(cfg: ModelConfig) -> int:
    return cfg.lru_width or cfg.d_model


def rglru_def(cfg: ModelConfig, tp: int = 16) -> dict:
    """The block's weights; ``lam`` stays float32 at every width, as in the
    reference."""
    d, w, pd = cfg.d_model, _width(cfg), cfg.param_dtype
    in_spec = P("data" if divisible(d, tp) else None,
                "model" if divisible(w, tp) else None)
    diag = P("model" if divisible(w, tp) else None)
    full = P(None, None)
    return {
        "w_branch": ParamDef((d, w), init="scaled", fan_in=d, dtype=pd,
                             spec=in_spec),
        "w_gate": ParamDef((d, w), init="scaled", fan_in=d, dtype=pd,
                           spec=in_spec),
        "conv_w": ParamDef((CONV_K, w), init="scaled", fan_in=CONV_K,
                           dtype=pd, spec=full),
        "conv_b": ParamDef((w,), init="zeros", dtype=pd, spec=P(None)),
        "w_a": ParamDef((w, w), init="scaled", fan_in=w, dtype=pd,
                        spec=full),
        "b_a": ParamDef((w,), init="zeros", dtype=pd, spec=diag),
        "w_x": ParamDef((w, w), init="scaled", fan_in=w, dtype=pd,
                        spec=full),
        "b_x": ParamDef((w,), init="zeros", dtype=pd, spec=diag),
        "lam": ParamDef((w,), init="ones", dtype=torch.float32, spec=diag),
        "w_out": ParamDef((w, d), init="scaled", fan_in=w, dtype=pd,
                          spec=P("model" if divisible(w, tp) else None,
                                 "data" if divisible(d, tp) else None)),
    }


def init_rglru_state(cfg: ModelConfig, batch: int, device: torch.device,
                     dtype=torch.float32) -> dict:
    """Zero recurrent state: ``h`` [B, W] and the conv window ``conv``
    [B, CONV_K - 1, W]."""
    w = _width(cfg)
    return {"h": torch.zeros((batch, w), dtype=dtype, device=device),
            "conv": torch.zeros((batch, CONV_K - 1, w), dtype=dtype,
                                device=device)}


def _gates(p, x: torch.Tensor, x_ch: Optional[torch.Tensor] = None):
    """x [.., W_in] -> (log_a, gated input), both float32; the gates read
    all of x (against ``w_a`` / ``w_x`` [W_in, W]) and gate ``x_ch``'s
    channels (None: x itself); the products in float32 whatever the
    compute dtype, as the reference's."""
    xf = x.float()
    r = torch.sigmoid(xf @ p["w_a"].float() + p["b_a"].float())
    i = torch.sigmoid(xf @ p["w_x"].float() + p["b_x"].float())
    log_a = C_FACTOR * r * F.logsigmoid(p["lam"].float())    # <= 0
    return log_a, i * (xf if x_ch is None else x_ch.float())


def _lru_scan(log_a: torch.Tensor, gated: torch.Tensor,
              h0: Optional[torch.Tensor]) -> torch.Tensor:
    """h_t = a_t h_{t-1} + sqrt(1 - a_t^2) x_t over axis 1, a_t =
    exp(log_a_t), from h0 (None: zero).  The pairs (a, b) combine as
    (a1, b1) then (a2, b2) -> (a1 a2, a2 b1 + b2); a doubling scan takes
    ceil(log2 S) passes, each folding in the pair ``d`` steps back (d = 1,
    2, 4, ...).  h0 joins as a virtual step 0 with a = 0, as in the
    reference."""
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * gated
    if h0 is not None:
        a = torch.cat([torch.zeros_like(a[:, :1]), a], dim=1)
        b = torch.cat([h0[:, None, :].to(b.dtype), b], dim=1)
    s, d = a.shape[1], 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b[:, 1:] if h0 is not None else b


def check_call(s: int, state: Optional[dict], decode: bool) -> None:
    """A decode step takes one token against a state; a prefill with a
    state is no shorter than the conv window it stashes."""
    if decode and (state is None or s != 1):
        raise ValueError("decode takes one token against a state")
    if not decode and state is not None and s < CONV_K - 1:
        raise ValueError(f"a prefill of {s} tokens is shorter than the "
                         f"conv window of {CONV_K - 1} rows it stashes")


def rglru_conv(p, x: torch.Tensor, cfg: ModelConfig, *,
               conv: Optional[torch.Tensor] = None, decode: bool = False):
    """The branch and GELU-gate linears and the causal conv on the branch:
    x [B, S, D] -> (z [B, S, W] float32, gate [B, S, W] compute dtype).
    The conv window ``conv`` [B, CONV_K - 1, W], when given, is updated
    in place; a prefill zero-pads the window whatever ``conv`` holds."""
    s = x.shape[1]
    ct = cfg.compute_dtype
    branch = x.to(ct) @ p["w_branch"].to(ct)
    gate = F.gelu(x.to(ct) @ p["w_gate"].to(ct), approximate="tanh")
    cw, cb = p["conv_w"].float(), p["conv_b"].float()
    if decode:
        conv_in = torch.cat([conv, branch.to(conv.dtype)], dim=1)
        z = (torch.einsum("bkw,kw->bw", conv_in.float(), cw) + cb)[:, None]
        conv.copy_(conv_in[:, 1:])
        return z, gate
    k = CONV_K - 1
    pad = F.pad(branch.float(), (0, 0, k, 0))
    z = sum(pad[:, i:i + s, :] * cw[i] for i in range(CONV_K)) + cb
    if conv is not None:
        conv.copy_(branch[:, -k:])
    return z, gate


def rglru_recur(p, z_in: torch.Tensor, z: torch.Tensor, gate: torch.Tensor,
                cfg: ModelConfig, *, h: Optional[torch.Tensor] = None,
                decode: bool = False) -> torch.Tensor:
    """The RG-LRU, the merge and the output linear: the gates read all of
    ``z_in``, the recurrence runs on ``z``'s channels from ``h`` [B, W]
    (None: zero; updated in place), then ``(y * gate) @ w_out``.  The
    block passes its z twice; a rank of a mesh passes all of z and its
    own channels (``models.sharded``)."""
    ct = cfg.compute_dtype
    log_a, gated = _gates(p, z_in, z)
    if decode:
        a = torch.exp(log_a[:, 0])
        hn = (a * h.float()
              + torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * gated[:, 0])
        h.copy_(hn)
        y = hn[:, None, :]
    else:
        y = _lru_scan(log_a, gated, None if h is None else h.float())
        if h is not None:
            h.copy_(y[:, -1])
    return (y.to(ct) * gate) @ p["w_out"].to(ct)


def rglru_apply(p, x: torch.Tensor, cfg: ModelConfig, *,
                state: Optional[dict] = None, decode: bool = False):
    """x [B, S, D] -> (y [B, S, D], state); the state, when given, is
    updated in place.

    A prefill with a state starts the recurrence from ``state["h"]`` but
    zero-pads the conv window, ignoring ``state["conv"]``, as the
    reference does (``repro/models/rglru.py:126-130``); it stashes the
    trailing ``CONV_K - 1`` rows of the branch.  A prefill with a state
    shorter than that raises (the reference would stash a window of the
    wrong length)."""
    check_call(x.shape[1], state, decode)
    st = state or {}
    z, gate = rglru_conv(p, x, cfg, conv=st.get("conv"), decode=decode)
    return rglru_recur(p, z, z, gate, cfg, h=st.get("h"),
                       decode=decode), state
