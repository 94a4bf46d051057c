"""Kernel K3 for Hopper: blocked online-softmax GQA attention, causal or
not, with an optional sliding window: the attention of every prefill
(non-causal for an encoder's self-attention and for cross-attention, at
any Sq and Sk).

    o[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h // G] / sqrt(Dqk)) v[b, j, h // G]
    over j <= i (causal) and j > i - window (window); positions from 0.

Replaces ``src/repro/kernels/flash_attention.py::flash_attention_pallas``
(body ``_attn_kernel``).  CUDA C++ in ``csrc/flash_attention.cu``, for
(q.k width, v width) = (64, 64), (128, 128), (256, 256) (recurrentgemma's
local layers) and (192, 128) (MLA's prefill: 128 nope + 64 rope columns of
q and k, v 128), in float32 and bfloat16.

Bound: at the main-path shape (B 8, S 1024, H = KH = 16, Dh 64, bf16,
causal) bytes and tensor-core operations about equally: 17.2 GFLOP,
0.0174 ms at 989 TFLOP/s, against 67.1 MB of q/k/v/o, 0.0200 ms at
3.35 TB/s.  The bf16 kernel runs both products on the tensor cores
(``wgmma``): TMA copies the q tile and a ring of K/V tiles into shared
memory, two warpgroups of 64 q rows take turns at the tensor cores so one's
softmax overlaps the other's products, P goes from registers into P.V in
bf16, and key tiles outside the causal or window band are never loaded
(see the source).  Its precision: the scores, the softmax, l and the
accumulator are f32 as in the plain version; P is rounded to bf16 for the
P.V product (2^-9 relative per weight, averaged over the keys), which
keeps the output within two bf16 ulps plus 1e-2 of the plain version.  The
f32 kernel runs both products on the tensor cores too (``mma.sync``
m16n8k8) as three TF32 products (3xTF32), which meets the 2e-5 tolerance
that one TF32 pass misses; K and V tiles come in by ``cp.async``, and each
tile's P.V is summed from zero and added in f32, so the error does not
grow with the sequence.

The plain version is ``ref.attention_ref`` (past Sq·Sk = 2048² its
blocked form, as the reference's).  The wrapper takes it for CPU
tensors, and on the card only when asked (``use_kernel=False``: the train
path's forward, which autograd differentiates, and on-card comparison); a
CUDA tensor otherwise reaches the kernel or raises.  The kernel has no
backward: in grad mode, an input that requires grad raises rather than
pass through a launch that records no autograd node (ROADMAP.md §1,
module 10).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref

DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# (q.k width Dqk, v width Dv) of the kernel's instances
HEAD_DIMS = ((64, 64), (128, 128), (256, 256), (192, 128))
ALIGN = 16                     # bytes; TMA needs each base 16-byte aligned


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  window: Optional[int]) -> None:
    """What both the kernel and its plain version need."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"need q [B, Sq, H, Dqk], k [B, Sk, KH, Dqk] and v "
                         f"[B, Sk, KH, Dv]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, dh = q.shape
    _, sk, kh, _ = k.shape
    if k.shape[0] != b or k.shape[3] != dh or kh == 0 or h % kh:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)}: batch and "
                         "head_dim must agree and KH divide H")
    if sq == 0 or sk == 0:
        raise ValueError("empty query or key sequence")
    if window is not None and (window < 1 or sq >= sk + window):
        # a query row at or past Sk + window would see no key at all
        raise ValueError(f"window {window} with Sq {sq}, Sk {sk}: need "
                         "window >= 1 and Sq < Sk + window")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v in {q.dtype}, {k.dtype}, {v.dtype}")


def check_instance(dqk: int, dv: int) -> None:
    """Raise unless the kernel has an instance for (q.k width, v width):
    the C entries refuse any other pair."""
    if (dqk, dv) not in HEAD_DIMS:
        raise ValueError(f"(q.k width, v width) {(dqk, dv)} not in "
                         f"{HEAD_DIMS}")


def check_no_grad(kernel: str, *tensors) -> None:
    """Raise if autograd would need a backward of ``kernel``: grad mode is
    on and an input requires grad.  The kernels are forward-only, and a
    launch records no autograd node, so the loss would get no gradient
    through them and nothing would say so."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} has no backward and an input requires grad: pass "
            "use_kernel=False to differentiate the plain version, as the "
            "train path does, or run under torch.no_grad() (ROADMAP.md §1, "
            "module 10; §2 queues the backward kernels)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    use_kernel: bool = True) -> torch.Tensor:
    """q: [B, Sq, H, Dqk]; k: [B, Sk, KH, Dqk]; v: [B, Sk, KH, Dv],
    H = KH * G.  Returns [B, Sq, H, Dv] in q's dtype.  On the card:
    contiguous f32 or bf16, (Dqk, Dv) in ``HEAD_DIMS``."""
    _check_inputs(q, k, v, window)
    if not q.is_cuda or not use_kernel:
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    check_no_grad("flash_attention (K3)", q, k, v)
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention takes {list(DTYPES)}, got {q.dtype}")
    b, sq, h, dh = q.shape
    sk, kh, dv = k.shape[1], k.shape[2], v.shape[3]
    check_instance(dh, dv)
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % ALIGN:
            raise ValueError(f"{name} must start on a {ALIGN}-byte boundary")
    out = q.new_empty((b, sq, h, dv))
    name = f"flash_attention_{DTYPES[q.dtype]}"
    err = getattr(build.library("flash_attention"), name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, sq, sk, h, kh, dh, dv, int(causal), int(window or 0),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, name)
    flash_attention.launches += 1
    flash_attention.noncausal_launches += not causal
    return out


flash_attention.launches = 0
flash_attention.noncausal_launches = 0      # of ``launches``
