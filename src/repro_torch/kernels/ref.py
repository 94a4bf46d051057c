"""Plain PyTorch versions of the port's kernels.

These are the CPU path of every kernel wrapper and the yardstick the CUDA
kernels are held against on the card.  They repeat the reference's
arithmetic (``repro.kernels.ref``): f32 accumulation, one cast on write.
The OTA kernels carry a leading cell axis.
Each keeps a plain call count (``.calls``), so that a run can show that its
CUDA path never fell back to them.
"""
from __future__ import annotations

from typing import Optional

import torch


def ota_aggregate_ref(g: torch.Tensor, s: torch.Tensor, z: torch.Tensor,
                      noise_scale: torch.Tensor) -> torch.Tensor:
    """out[c] = sum_m s[c, m] g[c, m] + noise_scale[c] z[c].

    g: [C, N, D] (f32 or bf16); s: [C, N]; z: [C, D]; noise_scale: [C].
    Returns [C, D] in g's dtype.
    """
    ota_aggregate_ref.calls += 1
    acc = torch.sum(g.float() * s[..., None].float(), dim=1)
    return (acc + noise_scale[:, None].float() * z.float()).to(g.dtype)


def ota_round_step_ref(g: torch.Tensor, s: torch.Tensor, z: torch.Tensor,
                       noise_scale: torch.Tensor, params: torch.Tensor,
                       eta: torch.Tensor,
                       q_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The fused round tail on flat arrays:

        ghat[c] = sum_m (g[c, m] qs[c, m]) s[c, m] + noise_scale[c] z[c]
        out[c]  = params[c] - eta[c] ghat[c]

    g: [C, N, D] wire dtype (f32, bf16 or int8); s, q_scale: [C, N];
    z, params: [C, D]; noise_scale, eta: [C].  ``q_scale`` is the int8
    uplink's per-device dequantization scale (None: the f32 cast alone
    dequantizes).  Returns [C, D] in params' dtype.
    """
    ota_round_step_ref.calls += 1
    gf = g.float()
    if q_scale is not None:
        gf = gf * q_scale[..., None].float()
    acc = torch.sum(gf * s[..., None].float(), dim=1)
    ghat = acc + noise_scale[:, None].float() * z.float()
    return (params.float() - eta[:, None].float() * ghat).to(params.dtype)


NEG_INF = -1e30


def grouped_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      qpos: torch.Tensor, kpos: torch.Tensor, *,
                      causal: bool, window: Optional[int]) -> torch.Tensor:
    """Naive full-score GQA attention over explicit positions.

    q: [B, Sq, H, Dh]; k, v: [B, Sk, KH, Dh], H = KH * G; qpos: [Sq],
    kpos: [Sk].  Scores and softmax in float32; masked scores are -1e30.
    Returns [B, Sq, H, Dh] in q's dtype.  Not counted: decode steps call it
    directly (the reference's direct form; its blocked form for
    Sq·Sk > 2048² computes the same function).
    """
    b, sq, h, dh = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, sq, kh, h // kh, dh).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    s = s / torch.sqrt(torch.tensor(dh, dtype=torch.float32))
    mask = torch.ones((sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > (qpos[:, None] - window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(b, sq, h, dh).to(q.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """K3's plain version: ``grouped_attention`` with positions from 0 on
    both sides, counted."""
    attention_ref.calls += 1
    qpos = torch.arange(q.shape[1], device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    return grouped_attention(q, k, v, qpos, kpos, causal=causal,
                             window=window)


ota_aggregate_ref.calls = 0
ota_round_step_ref.calls = 0
attention_ref.calls = 0
