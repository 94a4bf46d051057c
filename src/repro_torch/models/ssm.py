"""Mamba-2 (SSD, state-space duality) mixer of the port.

A copy of ``repro.models.ssm``: in_proj -> (z, xBC, dt); a causal
depthwise conv over xBC; the SSD scan; a gated RMSNorm; out_proj.  The
casts are the reference's: in_proj in the compute dtype, dt =
softplus(dt + dt_bias) and the conv in float32, ``y.to(ct) * silu(z)``,
then the norm and out_proj.

A prefill's scan is kernel K4 (``kernels.ssd_scan``), started from the
cache's state; it writes the final state and the trailing ``ssm_conv - 1``
rows of xBC (before the conv) into the cache, in place (the reference
returns a new state).  A decode step (one token against the recurrent
state) stays plain PyTorch, as the reference computes it outside any
Pallas kernel.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rmsnorm
from repro_torch.models.param import ParamDef


def _dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_headdim
    conv_dim = d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return d_inner, nheads, conv_dim


def ssd_def(cfg: ModelConfig) -> dict:
    """The mixer's weights; ``a_log``, ``dt_bias`` and ``d_skip`` stay
    float32 at every width, as in the reference."""
    d = cfg.d_model
    d_inner, nheads, conv_dim = _dims(cfg)
    d_in_proj = 2 * d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state + nheads
    pd = cfg.param_dtype
    return {
        "in_proj": ParamDef((d, d_in_proj), init="scaled", fan_in=d, dtype=pd),
        "conv_w": ParamDef((cfg.ssm_conv, conv_dim), init="scaled",
                           fan_in=cfg.ssm_conv, dtype=pd),
        "conv_b": ParamDef((conv_dim,), init="zeros", dtype=pd),
        "a_log": ParamDef((nheads,), init="zeros", dtype=torch.float32),
        "dt_bias": ParamDef((nheads,), init="zeros", dtype=torch.float32),
        "d_skip": ParamDef((nheads,), init="ones", dtype=torch.float32),
        "norm": ParamDef((d_inner,), init="ones", dtype=pd),
        "out_proj": ParamDef((d_inner, d), init="scaled", fan_in=d_inner,
                             dtype=pd),
    }


def init_ssd_state(cfg: ModelConfig, batch: int, device: torch.device,
                   dtype=torch.float32) -> dict:
    """Zero recurrent state: ``ssm`` [B, H, P, N] and the conv window
    ``conv`` [B, ssm_conv - 1, conv_dim]."""
    _, nheads, conv_dim = _dims(cfg)
    return {"ssm": torch.zeros((batch, nheads, cfg.ssm_headdim,
                                cfg.ssm_state), dtype=dtype, device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim),
                                dtype=dtype, device=device)}


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, log(1 + e^x), at every x
    (``torch.nn.functional.softplus`` turns into the identity above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """xbc [B, L, C]; depthwise causal conv with kernel w [K, C], bias b
    [C], then SiLU; the taps summed in the reference's order."""
    k, length = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + length, :] * w[i] for i in range(k))
    return F.silu(out + b)


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    d_inner, _, conv_dim = _dims(cfg)
    return torch.split(zxbcdt, [d_inner, conv_dim,
                                zxbcdt.shape[-1] - d_inner - conv_dim], -1)


def ssd_apply(p, x: torch.Tensor, cfg: ModelConfig, *,
              state: Optional[dict] = None, decode: bool = False,
              use_kernel: bool = True):
    """Mamba-2 mixer.  x [B, S, D] -> (y [B, S, D], state); the state, when
    given, is updated in place.  ``use_kernel=False`` computes a prefill's
    scan with K4's plain version: the train path's forward, which autograd
    differentiates, and on-card comparison."""
    bsz, s, _ = x.shape
    d_inner, nheads, _ = _dims(cfg)
    g, n, hd = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_headdim
    ct = cfg.compute_dtype

    zxbcdt = x.to(ct) @ p["in_proj"].to(ct)
    z, xbc, dt = _split_proj(cfg, zxbcdt)
    dt = _softplus(dt.float() + p["dt_bias"])             # [B, S, H]
    a_neg = -torch.exp(p["a_log"])                        # [H] < 0

    if decode:
        if state is None or s != 1:
            raise ValueError("decode takes one token against a state")
        # conv ring: shift in the new xBC row
        conv_in = torch.cat([state["conv"], xbc.to(state["conv"].dtype)], 1)
        xbc_t = F.silu(torch.einsum("bkc,kc->bc", conv_in.float(),
                                    p["conv_w"].float())
                       + p["conv_b"].float())
        xs, b_t, c_t = torch.split(xbc_t, [d_inner, g * n, g * n], -1)
        xh = xs.reshape(bsz, nheads, hd)
        rep = nheads // g
        bh = b_t.reshape(bsz, g, n).repeat_interleave(rep, dim=1)   # [B,H,N]
        chh = c_t.reshape(bsz, g, n).repeat_interleave(rep, dim=1)
        dt1 = dt[:, 0, :]                                 # [B, H]
        da = torch.exp(dt1 * a_neg)
        s_new = (state["ssm"] * da[..., None, None]
                 + torch.einsum("bh,bhn,bhp->bhpn", dt1, bh, xh))
        y = torch.einsum("bhn,bhpn->bhp", chh, s_new)
        y = (y + p["d_skip"][:, None] * xh).reshape(bsz, 1, d_inner)
        state["conv"].copy_(conv_in[:, 1:])
        state["ssm"].copy_(s_new)
    else:
        k = cfg.ssm_conv - 1
        if state is not None and s < k:
            raise ValueError(f"a prefill of {s} tokens is shorter than the "
                             f"conv window of {k} rows it stashes")
        xbc_conv = _causal_conv(xbc.float(), p["conv_w"].float(),
                                p["conv_b"].float())
        # K4 takes contiguous inputs: the split's views are copied out
        xs, b_mat, c_mat = (t.contiguous() for t in torch.split(
            xbc_conv, [d_inner, g * n, g * n], -1))
        xh = xs.reshape(bsz, s, nheads, hd)
        # a ragged S is masked in K4 (and padded with dt = 0 in its plain
        # version), the reference's zero-padding to a chunk multiple
        y, s_fin = ssd_scan(xh, dt, a_neg, b_mat.reshape(bsz, s, g, n),
                            c_mat.reshape(bsz, s, g, n),
                            chunk=min(cfg.ssm_chunk, s),
                            state0=None if state is None else state["ssm"],
                            use_kernel=use_kernel)
        y = (y + p["d_skip"][:, None] * xh).reshape(bsz, s, d_inner)
        if state is not None:       # prefill: stash the trailing conv window
            state["ssm"].copy_(s_fin)
            state["conv"].copy_(xbc[:, -k:])

    # gated RMSNorm, then the out projection
    y = y.to(ct) * F.silu(z)
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    return y.to(ct) @ p["out_proj"].to(ct), state
