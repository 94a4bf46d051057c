"""Plain PyTorch versions of the port's kernels.

These are the CPU path of every kernel wrapper and the yardstick the CUDA
kernels are held against on the card.  They repeat the reference's
arithmetic (``repro.kernels.ref``): f32 accumulation, one cast on write.
The OTA kernels carry a leading cell axis, and their plain versions take
the kernels' own order of operations (a loop over the devices, one
rounded op at a time), so that the card holds K1 and K2 to them bit for
bit.
Each kernel's plain version keeps a plain call count (``.calls``), so
that a run can show that its CUDA path never fell back to them.  K3's
plain version (``attention_ref``) is, as the reference's attention, the
direct form up to Sq·Sk = 2048² and an online softmax over key blocks
past it (``grouped_attention_blocked``, differentiable at O(S) memory: the
train path's attention at long sequences).
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
    dtype.  Not counted: decode steps call it directly.  The reference's
    direct form; ``attention_ref`` takes ``grouped_attention_blocked``
    past Sq·Sk = 2048², as the reference's ``grouped_attention`` takes its
    blocked form there.
    """
    b, sq, h, dh = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, sq, kh, h // kh, dh).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    s = s / torch.sqrt(torch.tensor(dh, dtype=torch.float32))
    s = torch.where(_mask(qpos, kpos, causal, window), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    """[Sq, Sk] allowed (query, key) pairs."""
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > (qpos[:, None] - window)
    return mask


def _blocks(q, k, v, kpos, block_k):
    """The blocked form's f32 operands: q [B, Sq, KH, G, Dqk], k and v
    padded to a multiple of ``block_k`` keys, the padded key positions,
    each key's validity (False on the padding) and the scale."""
    b, sq, h, dqk = q.shape
    sk, kh = k.shape[1], k.shape[2]
    pad = (-sk) % block_k
    scale = 1.0 / torch.sqrt(torch.tensor(dqk, dtype=torch.float32,
                                          device=q.device))
    return (q.reshape(b, sq, kh, h // kh, dqk).float(),
            F.pad(k.float(), (0, 0, 0, 0, 0, pad)),
            F.pad(v.float(), (0, 0, 0, 0, 0, pad)), F.pad(kpos, (0, pad)),
            torch.arange(sk + pad, device=q.device) < sk, scale)


class _BlockedAttention(torch.autograd.Function):
    """``grouped_attention_blocked``'s forward and backward; see there."""

    @staticmethod
    def forward(ctx, q, k, v, qpos, kpos, causal, window, block_k):
        qf, kf, vf, kpos_f, valid, scale = _blocks(q, k, v, kpos, block_k)
        b, sq, kh, g, _ = qf.shape
        dv = v.shape[-1]
        m = torch.full((b, kh, g, sq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, kh, g, sq, dv), dtype=torch.float32,
                          device=q.device)
        for j in range(0, kf.shape[1], block_k):
            blk = slice(j, j + block_k)
            s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf[:, blk]) * scale
            mask = _mask(qpos, kpos_f[blk], causal, window) & valid[blk]
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p, vf[:, blk])
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, kh * g, dv)
        lse = m + torch.log(l)
        ctx.save_for_backward(q, k, v, qpos, kpos, out, lse)
        ctx.causal, ctx.window, ctx.block_k = causal, window, block_k
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, qpos, kpos, out, lse = ctx.saved_tensors
        causal, window, block_k = ctx.causal, ctx.window, ctx.block_k
        qf, kf, vf, kpos_f, valid, scale = _blocks(q, k, v, kpos, block_k)
        b, sq, kh, g, _ = qf.shape
        sk, dv = k.shape[1], v.shape[-1]
        do = d_out.float().reshape(b, sq, kh, g, dv)
        # D = rowsum(dO * O), [B, KH, G, Sq]
        big_d = (do * out.reshape(b, sq, kh, g, dv)).sum(-1).permute(
            0, 2, 3, 1)
        dq = torch.zeros_like(qf)
        dk = torch.zeros_like(kf)
        dv_ = torch.zeros_like(vf)
        for j in range(0, kf.shape[1], block_k):
            blk = slice(j, j + block_k)
            s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf[:, blk]) * scale
            mask = _mask(qpos, kpos_f[blk], causal, window) & valid[blk]
            p = torch.exp(torch.where(mask, s, NEG_INF) - lse[..., None])
            dv_[:, blk] = torch.einsum("bkgqs,bqkgd->bskd", p, do)
            dp = torch.einsum("bqkgd,bskd->bkgqs", do, vf[:, blk])
            ds = p * (dp - big_d[..., None]) * scale
            dq += torch.einsum("bkgqs,bskd->bqkgd", ds, kf[:, blk])
            dk[:, blk] = torch.einsum("bkgqs,bqkgd->bskd", ds, qf)
        return (dq.reshape(q.shape).to(q.dtype), dk[:, :sk].to(k.dtype),
                dv_[:, :sk].to(v.dtype), None, None, None, None, None)


def grouped_attention_blocked(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, qpos: torch.Tensor,
                              kpos: torch.Tensor, *, causal: bool,
                              window: Optional[int],
                              block_k: int = 1024) -> torch.Tensor:
    """``grouped_attention`` as an online softmax over key blocks, the
    reference's blocked form (``repro/models/attention.py:80-121``): the
    same shapes, f32 throughout, keys padded to a multiple of ``block_k``,
    masked scores -1e30, the running max m, sum l and accumulator rescaled
    by exp(m_prev - m_new) at each block, ``acc / max(l, 1e-30)`` at the
    end.  Returns [B, Sq, H, Dv] in q's dtype.

    One departure: the padded keys are masked by an explicit validity mask
    in every mode.  The reference gives them the position max(qpos) + 1,
    which only the causal mask removes, so its non-causal blocked form
    lets the zero keys into every row's softmax when Sk is not a multiple
    of ``block_k`` (it then differs from its own direct form); this one
    computes the direct form's function there too.

    Differentiable, at O(S) memory: the forward saves q, k, v, the f32
    output and each row's log-sum-exp, nothing with both an Sq and an Sk
    extent, and the backward walks the key blocks again, recomputing each
    block's p = exp(s - lse): dv += p^T dO, dp = dO v^T,
    ds = p (dp - rowsum(dO O)), dq += ds k scale, dk += ds^T q scale
    (summed over the G query heads of a KV head).  Gradients come back in
    the inputs' dtypes.
    """
    return _BlockedAttention.apply(q, k, v, qpos, kpos, causal, window,
                                   block_k)


# Sq * Sk past which the reference's ``grouped_attention`` takes its blocked
# form (``repro/models/attention.py:80``)
BLOCKED_ABOVE = 2048 * 2048


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """K3's plain version, with positions from 0 on both sides, counted:
    ``grouped_attention`` up to Sq·Sk = 2048², ``grouped_attention_blocked``
    past it, as the reference chooses between its two forms."""
    attention_ref.calls += 1
    qpos = torch.arange(q.shape[1], device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    form = grouped_attention_blocked \
        if q.shape[1] * k.shape[1] > BLOCKED_ABOVE else grouped_attention
    return form(q, k, v, qpos, kpos, causal=causal, window=window)


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
