"""Plain PyTorch versions of the port's kernels.

These are the CPU path of every kernel wrapper and the yardstick the CUDA
kernels are held against on the card.  They repeat the reference's
arithmetic (``repro.kernels.ref``): f32 accumulation, one cast on write.
The OTA kernels carry a leading cell axis, and their plain versions take
the kernels' own order of operations (a loop over the devices, one
rounded op at a time), so that the card holds K1 and K2 to them bit for
bit.
Each kernel's plain version keeps a plain call count (``.calls``), so
that a run can show that its CUDA path never fell back to them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def ota_aggregate_ref(g: torch.Tensor, s: torch.Tensor, z: torch.Tensor,
                      noise_scale: torch.Tensor) -> torch.Tensor:
    """out[c] = sum_m s[c, m] g[c, m] + noise_scale[c] z[c].

    g: [C, N, D] (f32 or bf16); s: [C, N]; z: [C, D]; noise_scale: [C].
    Returns [C, D] in g's dtype.  K2's exact arithmetic: an f32 loop over
    m = 0..N-1, ``acc = acc + g_m s_m``, then ``+ noise_scale z``, each a
    separate rounded op, and one cast on write.
    """
    ota_aggregate_ref.calls += 1
    sf = s.float()
    acc = torch.zeros(z.shape, dtype=torch.float32, device=g.device)
    for m in range(g.shape[1]):
        acc = acc + g[:, m].float() * sf[:, m, None]
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
    dequantizes, and the kernel's x 1 is exact).  Returns [C, D] in
    params' dtype.  K1's exact arithmetic: an f32 loop over m = 0..N-1,
    ``acc = acc + (g_m qs_m) s_m``, then ``+ noise_scale z``, then
    ``params - eta ghat``, each a separate rounded op.
    """
    ota_round_step_ref.calls += 1
    sf = s.float()
    qf = None if q_scale is None else q_scale.float()
    acc = torch.zeros(z.shape, dtype=torch.float32, device=g.device)
    for m in range(g.shape[1]):
        gm = g[:, m].float()
        if qf is not None:
            gm = gm * qf[:, m, None]
        acc = acc + gm * sf[:, m, None]
    ghat = acc + noise_scale[:, None].float() * z.float()
    return (params.float() - eta[:, None].float() * ghat).to(params.dtype)


NEG_INF = -1e30


def grouped_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      qpos: torch.Tensor, kpos: torch.Tensor, *,
                      causal: bool, window: Optional[int]) -> torch.Tensor:
    """Naive full-score GQA attention over explicit positions.

    q: [B, Sq, H, Dqk]; k: [B, Sk, KH, Dqk]; v: [B, Sk, KH, Dv], H = KH * G;
    qpos: [Sq], kpos: [Sk].  Scores (scaled by 1/sqrt(Dqk)) and softmax in
    float32; masked scores are -1e30.  Returns [B, Sq, H, Dv] in q's
    dtype.  Not counted: decode steps call it
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
    return o.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


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


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_neg: torch.Tensor,
                b_mat: torch.Tensor, c_mat: torch.Tensor, chunk: int,
                state0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's plain version: the chunked SSD scan of
    ``repro.models.ssm.ssd_chunked``, counted.

    x: [B, L, H, P]; dt: [B, L, H] (> 0); a_neg: [H] (< 0); b_mat, c_mat:
    [B, L, G, N], G dividing H (head h reads group h // (H / G));
    state0: [B, H, P, N] or None (zeros).  Computes in float32.  Returns
    (y [B, L, H, P] in x's dtype, final state [B, H, P, N] float32).

    A length L that is not a multiple of ``chunk`` is zero-padded with
    dt = 0, as the reference's mixer pads before its call: the padding's
    decay is exp(0) = 1 and its input weight 0, so the final state is
    exact.  The decay exp(cum_i - cum_j) is taken only inside the causal
    triangle: above it cum_i - cum_j > 0 may overflow to inf.
    """
    ssd_chunked.calls += 1
    bsz, l, h, p_dim = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    pad = (-l) % chunk
    if pad:
        x, b_mat, c_mat = (F.pad(t, (0, 0, 0, 0, 0, pad))
                           for t in (x, b_mat, c_mat))
        dt = F.pad(dt, (0, 0, 0, pad))
    nc = (l + pad) // chunk
    rep = h // g

    dt = dt.float()
    d_a = dt * a_neg.float()[None, None, :]               # [B, L, H] (< 0)
    xw = x.float() * dt[..., None]                        # dt-weighted input
    xw_c = xw.reshape(bsz, nc, chunk, h, p_dim)
    cum = torch.cumsum(d_a.reshape(bsz, nc, chunk, h), dim=2)   # [B,NC,Q,H]
    seg_end = cum[:, :, -1:, :]                           # whole chunk decay
    bh = b_mat.float().reshape(bsz, nc, chunk, g, n)
    ch = c_mat.float().reshape(bsz, nc, chunk, g, n)
    if rep > 1:
        bh = bh.repeat_interleave(rep, dim=3)             # [B,NC,Q,H,N]
        ch = ch.repeat_interleave(rep, dim=3)

    # intra-chunk: att[i, j] = exp(cum_i - cum_j) (C_i . B_j), i >= j
    scores = torch.einsum("bcihn,bcjhn->bchij", ch, bh)
    cum_h = cum.permute(0, 1, 3, 2)                       # [B,NC,H,Q]
    decay = cum_h[..., :, None] - cum_h[..., None, :]     # [B,NC,H,Qi,Qj]
    above = torch.ones(chunk, chunk, dtype=torch.bool,
                       device=x.device).triu(1)
    att = scores * torch.exp(decay.masked_fill(above, float("-inf")))
    y_intra = torch.einsum("bchij,bcjhp->bcihp", att, xw_c)

    # each chunk's own state: sum_j exp(seg_end - cum_j) B_j (x) xw_j
    w_in = torch.exp(seg_end - cum)                       # [B,NC,Q,H]
    s_local = torch.einsum("bcjhn,bcjhp->bchpn", bh * w_in[..., None], xw_c)

    # across chunks: S_k = exp(seg_end_k) S_{k-1} + local_k
    seg_decay = torch.exp(seg_end[:, :, 0, :])            # [B,NC,H]
    state = (torch.zeros((bsz, h, p_dim, n), dtype=torch.float32,
                         device=x.device)
             if state0 is None else state0.float())
    s_in = []
    for k in range(nc):
        s_in.append(state)                                # entering chunk k
        state = state * seg_decay[:, k, :, None, None] + s_local[:, k]
    s_in = torch.stack(s_in, dim=1)                       # [B,NC,H,P,N]

    # inter-chunk output: y_i += exp(cum_i) C_i . S_in
    y_inter = torch.einsum("bcihn,bchpn->bcihp", ch, s_in) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(bsz, l + pad, h, p_dim)[:, :l]
    return y.to(x.dtype), state


ota_aggregate_ref.calls = 0
ota_round_step_ref.calls = 0
attention_ref.calls = 0
ssd_chunked.calls = 0
