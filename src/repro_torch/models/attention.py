"""GQA self-attention of the port's models, with QKV bias, qk-norm and
sliding-window (ring-cache) variants, the encoder's bidirectional kind,
the encoder-decoder's cross-attention, and DeepSeek-V3's multi-head
latent attention (MLA).

A copy of the GQA, cross-attention and MLA parts of
``repro.models.attention``.
A prefill computes its attention through kernel K3
(``kernels.flash_attention``): q and k share their positions there, and a
shared offset cancels in both masks, so K3's positions from 0 give the
same answer at any ``pos_offset``.  The encoder's ``enc_attn`` layers and
cross-attention (the reference's all-zero positions with ``causal=False``:
plain full attention over the memory) take K3's non-causal mode, at any
Sq and Sk.  A decode step (one query against the KV cache or the cross
cache) stays plain PyTorch (``kernels.ref.grouped_attention``, K3's plain
version over the cache's positions), as the reference computes it outside
any Pallas kernel.

MLA caches the compressed latents (``ckv`` [B, L, kv_lora_rank] and the
shared rope key ``krope`` [B, L, rope]), not per-head K and V.  Its
prefill is the reference's expanded form: per-head k_nope and v from the
latents, k = [k_nope, krope] and q = [q_nope, q_rope] (q.k width nope +
rope, 192 at full width; v width 128) through K3's (192, 128) instance,
causal, scaled by 1/sqrt(192).  Its decode step is the weight-absorbed
form in float32 against the latent cache, plain PyTorch, as the reference
computes it outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import NEG_INF, grouped_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_rope, dense, dense_def, rmsnorm,
                                       rmsnorm_def)
from repro_torch.models.param import P, ParamDef, divisible


def gqa_def(cfg: ModelConfig, tp: int = 16) -> dict:
    dh = cfg.resolved_head_dim
    d = cfg.d_model
    kv = cfg.n_kv_heads * dh
    kv_ax = "model" if divisible(kv, tp) else None
    defs = {
        "wq": dense_def(d, cfg.n_heads * dh, cfg, tp_out=True,
                        bias=cfg.qkv_bias, tp=tp),
        # k and v as one [D, 2, KV] weight, as the reference: the k/v axis
        # unsharded, KV over 'model'
        "wkv": ParamDef((d, 2, kv), init="scaled", fan_in=d,
                        dtype=cfg.param_dtype,
                        spec=P("data" if divisible(d, tp) else None, None,
                               kv_ax)),
        "wo": dense_def(cfg.n_heads * dh, d, cfg, tp_out=False, tp=tp),
    }
    if cfg.qkv_bias:
        defs["bkv"] = ParamDef((2, kv), init="zeros", dtype=cfg.param_dtype,
                               spec=P(None, kv_ax))
    if cfg.qk_norm:
        defs["q_norm"] = rmsnorm_def(dh, cfg.param_dtype)
        defs["k_norm"] = rmsnorm_def(dh, cfg.param_dtype)
    return defs


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, kind: str,
                  device: torch.device, dtype=None) -> dict:
    """Zero KV cache [B, L, KH, Dh] for one attention layer; a ring buffer
    of ``window`` slots for sliding/local layers longer than the window."""
    dh = cfg.resolved_head_dim
    dtype = dtype or cfg.compute_dtype
    if kind in ("swa", "local") and cfg.window and max_len > cfg.window:
        max_len = cfg.window
    shape = (batch, max_len, cfg.n_kv_heads, dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _cache_write(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                 pos: int, ring: bool) -> dict:
    """Insert [B, S, KH, Dh] at position ``pos``, IN PLACE (the reference
    returns a new cache); returns ``cache``.

    Ring buffer, S == 1: slot ``pos mod cap``.  Ring buffer, S >= cap: keep
    the trailing cap entries, slot j holding the entry whose absolute
    position is j mod cap.  Otherwise a linear write at ``pos``; a write
    past the end raises (the reference's dynamic_update_slice would clamp
    it onto the last slots).
    """
    s = k_new.shape[1]
    cap = cache["k"].shape[1]
    k_new = k_new.to(cache["k"].dtype)
    v_new = v_new.to(cache["v"].dtype)
    if ring and s == 1:
        idx = pos % cap
        cache["k"][:, idx:idx + 1] = k_new
        cache["v"][:, idx:idx + 1] = v_new
    elif ring and s >= cap:
        shift = (pos + s - cap) % cap
        cache["k"].copy_(torch.roll(k_new[:, -cap:], shift, dims=1))
        cache["v"].copy_(torch.roll(v_new[:, -cap:], shift, dims=1))
    else:
        if pos + s > cap:
            raise ValueError(f"cache write of {s} at {pos} past its {cap} slots")
        cache["k"][:, pos:pos + s] = k_new
        cache["v"][:, pos:pos + s] = v_new
    return cache


def gqa_q(p, x: torch.Tensor, cfg: ModelConfig, n_heads: int):
    """q [B, S, n_heads, Dh] from ``wq`` (its columns of n_heads heads),
    qk-normed; no RoPE yet."""
    b, s, _ = x.shape
    dh = cfg.resolved_head_dim
    q = dense(p["wq"], x, cfg.compute_dtype).reshape(b, s, n_heads, dh)
    return rmsnorm(p["q_norm"], q, cfg.norm_eps) if cfg.qk_norm else q


def gqa_kv(p, x: torch.Tensor, cfg: ModelConfig, n_kv_heads: int):
    """(k, v) [B, S, n_kv_heads, Dh] from ``wkv`` (its columns of
    n_kv_heads heads) and ``bkv``, k qk-normed; no RoPE yet."""
    b, s, _ = x.shape
    dh = cfg.resolved_head_dim
    wkv = p["wkv"].to(cfg.compute_dtype)                    # [D, 2, KV]
    kv2 = (x.to(cfg.compute_dtype) @ wkv.reshape(wkv.shape[0], -1)
           ).unflatten(-1, wkv.shape[1:])
    if "bkv" in p:
        kv2 = kv2 + p["bkv"].to(cfg.compute_dtype)
    k = kv2[..., 0, :].reshape(b, s, n_kv_heads, dh)
    v = kv2[..., 1, :].reshape(b, s, n_kv_heads, dh)
    if cfg.qk_norm:
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    return k, v


def gqa_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               cfg: ModelConfig, *, kind: str, pos_offset: int = 0,
               cache: Optional[dict] = None, decode: bool = False,
               use_kernel: bool = True, select=None, q_offset=0):
    """The attention of roped q [B, Sq, H, Dh] over roped k, v [B, S, KH,
    Dh] (S = Sq but for a query block), writing k and v into ``cache``
    first when given; [B, Sq, H, Dh].  ``select`` maps the cache's (or
    k's and v's) KV heads to those q's heads read (a rank's heads of a
    model sharded over a mesh); ``q_offset`` is the first query row's
    position in the segment (its query-sequence block)."""
    causal = kind != "enc_attn"
    window = cfg.window if kind in ("swa", "local") else None
    select = select or (lambda t: t)
    if decode:
        if cache is None or q.shape[1] != 1:
            raise ValueError("decode takes one token against a cache")
        cap = cache["k"].shape[1]
        ring = window is not None and cap <= window
        _cache_write(cache, k, v, pos_offset, ring)
        slots = torch.arange(cap, device=q.device)
        if ring:
            # absolute position of slot i from the write pointer; slots never
            # written decode to negative positions: push them into the future
            kpos = pos_offset - torch.remainder(pos_offset - slots, cap)
            kpos = torch.where(kpos < 0, pos_offset + 1, kpos)
        else:
            kpos = slots
        positions = pos_offset + torch.arange(1, device=q.device)
        return grouped_attention(q, select(cache["k"]), select(cache["v"]),
                                 positions, kpos, causal=True, window=window)
    if cache is not None:
        ring = window is not None and cache["k"].shape[1] <= window
        _cache_write(cache, k, v, pos_offset, ring)
    return flash_attention(q, select(k), select(v).contiguous(),
                           causal=causal, window=window,
                           use_kernel=use_kernel, q_offset=q_offset)


def gqa_apply(p, x: torch.Tensor, cfg: ModelConfig, *, kind: str = "attn",
              pos_offset: int = 0, cache: Optional[dict] = None,
              decode: bool = False, use_kernel: bool = True):
    """Self-attention.  Returns (out, cache); the cache, when given, is
    updated in place.

    kind: attn (full causal) | swa | local (sliding-window causal) |
    enc_attn (the encoder's: bidirectional, RoPE at 0..S-1, no cache).
    decode: S == 1, reads and updates the cache.  ``use_kernel=False``
    computes a prefill's attention with K3's plain version: the train
    path's forward, which autograd differentiates, and on-card comparison.
    """
    if kind not in ("attn", "swa", "local", "enc_attn"):
        raise ValueError(f"unknown attention kind {kind!r}")
    if kind == "enc_attn" and (decode or cache is not None):
        # the reference never decodes an encoder layer: its caches have no
        # entry for one
        raise ValueError("an enc_attn layer keeps no cache and never decodes")
    b, s, _ = x.shape
    q = gqa_q(p, x, cfg, cfg.n_heads)
    k, v = gqa_kv(p, x, cfg, cfg.n_kv_heads)
    positions = pos_offset + torch.arange(s, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = gqa_attend(q, k, v, cfg, kind=kind, pos_offset=pos_offset,
                     cache=cache, decode=decode, use_kernel=use_kernel)
    out = out.reshape(b, s, -1)
    return dense(p["wo"], out, cfg.compute_dtype), cache


# ---------------------------------------------------------------------------
# Cross-attention (encoder-decoder)
# ---------------------------------------------------------------------------

def cross_def(cfg: ModelConfig, tp: int = 16) -> dict:
    """Separate q, k, v and output projections: no bias, no qk-norm, no
    RoPE, as the reference."""
    dh = cfg.resolved_head_dim
    d = cfg.d_model
    return {"wq": dense_def(d, cfg.n_heads * dh, cfg, tp_out=True, tp=tp),
            "wk": dense_def(d, cfg.n_kv_heads * dh, cfg, tp_out=True, tp=tp),
            "wv": dense_def(d, cfg.n_kv_heads * dh, cfg, tp_out=True, tp=tp),
            "wo": dense_def(cfg.n_heads * dh, d, cfg, tp_out=False, tp=tp)}


def cross_cache(p, memory: torch.Tensor, cfg: ModelConfig,
                kv_heads: Optional[int] = None) -> dict:
    """The encoder-side K and V [B, Sk, KH, Dh] in the compute dtype,
    computed once per request; ``kv_heads`` (default KH) is how many KV
    heads ``wk`` / ``wv`` hold (a rank's of a mesh)."""
    b, sk, _ = memory.shape
    kh, dh = kv_heads or cfg.n_kv_heads, cfg.resolved_head_dim
    ct = cfg.compute_dtype
    return {"k": dense(p["wk"], memory, ct).reshape(b, sk, kh, dh),
            "v": dense(p["wv"], memory, ct).reshape(b, sk, kh, dh)}


def cross_apply(p, x: torch.Tensor, memory: Optional[torch.Tensor],
                cfg: ModelConfig, *, cache: Optional[dict] = None,
                decode: bool = False, use_kernel: bool = True,
                heads: Optional[tuple] = None, select=None) -> torch.Tensor:
    """x: [B, Sq, D] decoder states; memory: [B, Sk, D] encoder output, or
    ``cache`` (``cross_cache``'s K and V over it; memory is then unused).

    Full attention of every query over every memory row: the reference's
    zero positions on both sides with ``causal=False``.  A prefill (any
    Sq) goes through K3's non-causal mode; a decode step (Sq = 1) reads
    the cache with the plain ``grouped_attention``, as the self-attention
    decode does.  ``heads`` (default (H, KH)) is how many q and KV heads
    the weights hold, and ``select`` picks the q heads' KV heads out of
    K and V (``gqa_attend``'s): a rank's of a mesh (``models.sharded``).
    """
    b, s, _ = x.shape
    h, kh = heads or (cfg.n_heads, cfg.n_kv_heads)
    dh = cfg.resolved_head_dim
    ct = cfg.compute_dtype
    q = dense(p["wq"], x, ct).reshape(b, s, h, dh)
    kv = cross_cache(p, memory, cfg, kh) if cache is None else cache
    k, v = kv["k"], kv["v"]
    if select is not None:
        k, v = select(k), select(v)
    if decode:
        zero_q = torch.zeros(s, dtype=torch.long, device=x.device)
        zero_k = torch.zeros(k.shape[1], dtype=torch.long, device=x.device)
        out = grouped_attention(q, k, v, zero_q, zero_k, causal=False,
                                window=None)
    else:
        out = flash_attention(q, k, v.contiguous(), causal=False,
                              use_kernel=use_kernel)
    out = out.reshape(b, s, h * dh)
    return dense(p["wo"], out, ct)


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (DeepSeek-V3)
# ---------------------------------------------------------------------------

def mla_def(cfg: ModelConfig, tp: int = 16) -> dict:
    """q through a low-rank bottleneck (``wq_a``, ``q_norm``, ``wq_b``) when
    ``q_lora_rank``, else ``wq``; k and v from one latent of
    ``kv_lora_rank`` plus a shared rope key (``wkv_a``, ``kv_norm``,
    ``wkv_b``); ``wo`` from the heads' v.  The reference's order."""
    d, h = cfg.d_model, cfg.n_heads
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    defs = {}
    if cfg.q_lora_rank:
        defs["wq_a"] = dense_def(d, cfg.q_lora_rank, cfg, tp_out=True, tp=tp)
        defs["q_norm"] = rmsnorm_def(cfg.q_lora_rank, cfg.param_dtype)
        defs["wq_b"] = dense_def(cfg.q_lora_rank, h * qk, cfg, tp_out=True,
                                 tp=tp)
    else:
        defs["wq"] = dense_def(d, h * qk, cfg, tp_out=True, tp=tp)
    defs["wkv_a"] = dense_def(d, cfg.kv_lora_rank + cfg.qk_rope_head_dim, cfg,
                              tp_out=True, tp=tp)
    defs["kv_norm"] = rmsnorm_def(cfg.kv_lora_rank, cfg.param_dtype)
    defs["wkv_b"] = dense_def(
        cfg.kv_lora_rank, h * (cfg.qk_nope_head_dim + cfg.v_head_dim), cfg,
        tp_out=True, tp=tp)
    defs["wo"] = dense_def(h * cfg.v_head_dim, d, cfg, tp_out=False, tp=tp)
    return defs


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   device: torch.device, dtype=None) -> dict:
    """Zero latent cache: ``ckv`` [B, L, kv_lora_rank] and ``krope``
    [B, L, rope] -- the point of MLA, O(kv_lora_rank + rope) a token."""
    dtype = dtype or cfg.compute_dtype
    return {"ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                               dtype=dtype, device=device),
            "krope": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                                 dtype=dtype, device=device)}


def _latent_write(cache: dict, ckv: torch.Tensor, krope: torch.Tensor,
                  pos: int) -> dict:
    """Insert [B, S, ...] latents at position ``pos``, IN PLACE; a write
    past the end raises (the reference's dynamic_update_slice would clamp
    it onto the last slots)."""
    s, cap = ckv.shape[1], cache["ckv"].shape[1]
    if pos + s > cap:
        raise ValueError(f"cache write of {s} at {pos} past its {cap} slots")
    cache["ckv"][:, pos:pos + s] = ckv.to(cache["ckv"].dtype)
    cache["krope"][:, pos:pos + s] = krope.to(cache["krope"].dtype)
    return cache


def _mla_q(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """(q_nope [B, S, H, nope], q_rope [B, S, H, rope]), RoPE on the
    latter."""
    b, s, _ = x.shape
    ct = cfg.compute_dtype
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    if cfg.q_lora_rank:
        cq = rmsnorm(p["q_norm"], dense(p["wq_a"], x, ct), cfg.norm_eps)
        q = dense(p["wq_b"], cq, ct)
    else:
        q = dense(p["wq"], x, ct)
    q = q.reshape(b, s, cfg.n_heads, qk)
    q_rope = apply_rope(q[..., cfg.qk_nope_head_dim:], positions,
                        cfg.rope_theta)
    return q[..., :cfg.qk_nope_head_dim], q_rope


def mla_apply(p, x: torch.Tensor, cfg: ModelConfig, *, pos_offset: int = 0,
              cache: Optional[dict] = None, decode: bool = False,
              use_kernel: bool = True):
    """Latent attention, causal.  Returns (out, cache); the cache, when
    given, is updated in place.

    A prefill (the train path's forward too) takes the expanded form
    through K3 (``use_kernel=False``: its plain version); a decode step
    (S == 1) the weight-absorbed form in float32 against the latent cache.
    """
    b, s, _ = x.shape
    h, ct = cfg.n_heads, cfg.compute_dtype
    r, nope = cfg.kv_lora_rank, cfg.qk_nope_head_dim
    positions = pos_offset + torch.arange(s, device=x.device)

    kv_a = dense(p["wkv_a"], x, ct)
    ckv = rmsnorm(p["kv_norm"], kv_a[..., :r], cfg.norm_eps)
    krope = apply_rope(kv_a[..., None, r:], positions,
                       cfg.rope_theta)[..., 0, :]             # [B, S, rope]
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    wkv_b = p["wkv_b"]["w"].to(ct).reshape(r, h, nope + cfg.v_head_dim)
    wk_b, wv_b = wkv_b[..., :nope], wkv_b[..., nope:]       # [R, H, D]

    if decode:
        if cache is None or s != 1:
            raise ValueError("decode takes one token against a cache")
        scale = 1.0 / torch.sqrt(torch.tensor(
            float(nope + cfg.qk_rope_head_dim), dtype=torch.float32))
        _latent_write(cache, ckv, krope, pos_offset)
        ckv_all = cache["ckv"].float()
        krope_all = cache["krope"].float()
        # absorbed: q_nope into the latent space
        q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope.float(), wk_b.float())
        sc = (torch.einsum("bqhr,bsr->bhqs", q_lat, ckv_all)
              + torch.einsum("bqhd,bsd->bhqs", q_rope.float(),
                             krope_all)) * scale
        kpos = torch.arange(ckv_all.shape[1], device=x.device)
        mask = kpos[None, :] <= positions[:, None]
        sc = torch.where(mask[None, None], sc, NEG_INF)
        pr = torch.softmax(sc, dim=-1)
        o_lat = torch.einsum("bhqs,bsr->bqhr", pr, ckv_all)
        out = torch.einsum("bqhr,rhd->bqhd", o_lat, wv_b.float())
    else:
        if cache is not None:
            _latent_write(cache, ckv, krope, pos_offset)
        # expanded: per-head k_nope and v from the latents; the rope key is
        # shared by the heads
        c = ckv.to(ct)
        k_nope = torch.einsum("bsr,rhd->bshd", c, wk_b)
        vv = torch.einsum("bsr,rhd->bshd", c, wv_b).contiguous()
        k_full = torch.cat([k_nope, krope[:, :, None, :].expand(
            b, s, h, cfg.qk_rope_head_dim)], dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        out = flash_attention(q_full, k_full, vv, causal=True,
                              use_kernel=use_kernel)

    out = out.reshape(b, s, h * cfg.v_head_dim)
    return dense(p["wo"], out, ct), cache
