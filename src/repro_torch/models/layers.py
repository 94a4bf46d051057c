"""Shared layers of the port's language models: RMSNorm, RoPE, dense, MLP,
embedding and unembedding.

Copies of ``repro.models.layers`` as plain functions on tensors, with the
reference's layouts (weights ``[d_in, d_out]``, the gated MLP's ``wi`` as
``[D, 2, F]``) and its casts: norms and RoPE in float32, matmuls in the
config's compute dtype, logits in float32.  The ``*_def`` functions give
each weight's shape, init law, dtype and the reference's sharding spec
for a model axis of ``tp`` (``repro_torch.models.param``): a
column-parallel weight's out-dim over "model" and in-dim over "data"
(FSDP), a row-parallel one the transpose.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.param import P, ParamDef, divisible


def rmsnorm_def(dim: int, dtype) -> ParamDef:
    return ParamDef((dim,), init="ones", dtype=dtype, spec=P(None))


def rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """Inverse frequencies [head_dim // 2] (float32)."""
    i = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (i / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, Dh] (rotates the last dim); positions: [S]."""
    inv = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., :, None].float() * inv            # [S, Dh/2]
    cos = torch.cos(ang)[..., :, None, :]                  # [S, 1, Dh/2]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def dense_def(d_in: int, d_out: int, cfg: ModelConfig, *, tp_out: bool,
              bias: bool = False, tp: int = 16) -> dict:
    """Weight [d_in, d_out]; ``tp_out``: out-dim over 'model'
    (column-parallel), else in-dim over 'model' (row-parallel); the other
    dim over 'data' (FSDP)."""
    if tp_out:
        spec = P("data" if divisible(d_in, tp) else None,
                 "model" if divisible(d_out, tp) else None)
        bspec = P("model" if divisible(d_out, tp) else None)
    else:
        spec = P("model" if divisible(d_in, tp) else None,
                 "data" if divisible(d_out, tp) else None)
        bspec = P(None)
    d = {"w": ParamDef((d_in, d_out), init="scaled", fan_in=d_in,
                       dtype=cfg.param_dtype, spec=spec)}
    if bias:
        d["b"] = ParamDef((d_out,), init="zeros", dtype=cfg.param_dtype,
                          spec=bspec)
    return d


def dense(p, x: torch.Tensor, compute_dtype) -> torch.Tensor:
    out = x.to(compute_dtype) @ p["w"].to(compute_dtype)
    if "b" in p:
        out = out + p["b"].to(compute_dtype)
    return out


def mlp_def(cfg: ModelConfig, d_ff: Optional[int] = None,
            tp: int = 16) -> dict:
    d_ff = d_ff or cfg.d_ff
    defs = {}
    if cfg.ffn_kind in ("swiglu", "geglu"):
        # gate and up projections as one [D, 2, F] weight, as the
        # reference; the gate/up axis unsharded, F over 'model'
        defs["wi"] = {"w": ParamDef(
            (cfg.d_model, 2, d_ff), init="scaled", fan_in=cfg.d_model,
            dtype=cfg.param_dtype,
            spec=P("data" if divisible(cfg.d_model, tp) else None, None,
                   "model" if divisible(d_ff, tp) else None))}
    else:
        defs["wi"] = dense_def(cfg.d_model, d_ff, cfg, tp_out=True, tp=tp)
    defs["wo"] = dense_def(d_ff, cfg.d_model, cfg, tp_out=False, tp=tp)
    return defs


def mlp(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    ct = cfg.compute_dtype
    if cfg.ffn_kind in ("swiglu", "geglu"):
        w = p["wi"]["w"].to(ct)                            # [D, 2, F]
        h2 = (x.to(ct) @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])
        up, gate = h2[..., 0, :], h2[..., 1, :]
        # jax.nn.gelu defaults to the tanh approximation
        act = F.silu(up) if cfg.ffn_kind == "swiglu" \
            else F.gelu(up, approximate="tanh")
        h = act * gate
    else:
        h = dense(p["wi"], x, ct)
        h = F.gelu(h, approximate="tanh") if cfg.ffn_kind == "gelu" \
            else F.relu(h)
    return dense(p["wo"], h, ct)


def embedding_def(cfg: ModelConfig, tp: int = 16) -> ParamDef:
    v = cfg.padded_vocab
    return ParamDef((v, cfg.d_model), init="embed", dtype=cfg.param_dtype,
                    spec=P("model" if divisible(v, tp) else None,
                           "data" if divisible(cfg.d_model, tp) else None))


def embed(table: torch.Tensor, ids: torch.Tensor, compute_dtype) -> torch.Tensor:
    return table[ids].to(compute_dtype)


def unembed_def(cfg: ModelConfig, tp: int = 16) -> ParamDef:
    v = cfg.padded_vocab
    return ParamDef((cfg.d_model, v), init="scaled", fan_in=cfg.d_model,
                    dtype=cfg.param_dtype,
                    spec=P("data" if divisible(cfg.d_model, tp) else None,
                           "model" if divisible(v, tp) else None))


def unembed(w: torch.Tensor, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits in float32 (softmax numerics)."""
    ct = cfg.compute_dtype
    logits = (x.to(ct) @ w.to(ct)).float()
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits
