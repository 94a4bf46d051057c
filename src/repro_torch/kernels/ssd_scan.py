"""Kernel K4 for Hopper: the Mamba-2 SSD chunk scan, with the state in and
out, the scan of every mamba2 prefill layer.

    S_t = exp(dt_t a_h) S_{t-1} + dt_t x_t (x) B_t,   S_0 = state0
    y_t = S_t C_t     per (batch, head h), B and C of group h // (H / G)

Replaces ``src/repro/kernels/ssd_scan.py::ssd_scan_pallas`` (body
``_ssd_kernel``), which starts from zero and returns y only; the model's
prefill also needs the final state (``repro.models.ssm.ssd_apply``), so K4
takes ``state0`` and returns it.  CUDA C++ in ``csrc/ssd_scan.cu``, for
P and N in (32, 64, 96, 128), inputs in float32 or bfloat16, computed in
float32.

Bound: at the main-path shape (B 8, S 1024, H 64, P 64, N 128, G 1, f32,
no state in) operations: 17.9 GFLOP of the chunked form at the tile length
that needs fewest (13 rows), 0.108 ms as three TF32 products on the tensor
cores at 495 TFLOP/s (0.27 ms on the f32 FMA units at 67 TFLOP/s),
against 295.7 MB moved, 0.088 ms at 3.35 TB/s.
One block per (head, batch) walks tiles of 64 rows with the state in
shared memory and runs the tile's three products on the tensor cores
(``mma.sync`` m16n8k8 TF32): C [B; S]^T (the scores and the inter-tile
term in one pass), the masked scores times dt x, and the state update (see
the source).  TF32 enters only there, and as 3xTF32: each operand is split
into a TF32 big half and the TF32 rounding of the rest, and small.big +
big.small + big.big carries the products to about f32's precision, so K4
keeps the f32 tolerance that one TF32 pass misses
(``tests/test_torch_ssm.py`` emulates both).  The running sums, exps,
masks and decays stay in f32.  The kernel's tile is its own: the SSD form
is exact for any chunk length, so ``chunk`` changes rounding only and is
what the plain version uses.  Rows past S are masked in the kernel as the
reference's padding with dt = 0, so a ragged S needs no padded copy.

The plain version is ``ref.ssd_chunked``.  The wrapper takes it for CPU
tensors, and on the card only when asked (``use_kernel=False``: the train
path's forward, which autograd differentiates, and on-card comparison); a
CUDA tensor otherwise reaches the kernel or raises.  The kernel has no
backward: in grad mode, an input that requires grad raises
(``flash_attention.check_no_grad``).  A fake on the card's path (the
dry-run's, ``launch.count.on_card``) is counted by ``work`` and never
launched, as K3's.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch import distributed as dist
from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_attention import check_no_grad
from repro_torch.launch import count

DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
DIMS = (32, 64, 96, 128)       # P and N the kernel is built for
MAX_BATCH = 65535              # batch rides gridDim.y
ALIGN = 16                     # bytes; the kernel stages x, B, C 16 bytes
                               # (f32) or 8 (bf16) a load


def _check_inputs(x, dt, a_neg, b_mat, c_mat, chunk, state0) -> None:
    """What both the kernel and its plain version need."""
    if x.dim() != 4 or b_mat.dim() != 4 or c_mat.shape != b_mat.shape:
        raise ValueError(f"need x [B, S, H, P] and b_mat, c_mat [B, S, G, N]; "
                         f"got {tuple(x.shape)}, {tuple(b_mat.shape)}, "
                         f"{tuple(c_mat.shape)}")
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    if tuple(dt.shape) != (bsz, s, h) or tuple(a_neg.shape) != (h,):
        raise ValueError(f"dt {tuple(dt.shape)} and a_neg "
                         f"{tuple(a_neg.shape)} do not fit x {tuple(x.shape)}")
    if b_mat.shape[:2] != x.shape[:2] or g == 0 or h % g:
        raise ValueError(f"b_mat {tuple(b_mat.shape)} and x {tuple(x.shape)}: "
                         "batch and length must agree and G divide H")
    if s == 0 or chunk < 1:
        raise ValueError(f"empty sequence or chunk {chunk} < 1")
    if state0 is not None and tuple(state0.shape) != (bsz, h, p, n):
        raise ValueError(f"state0 {tuple(state0.shape)}, need "
                         f"{(bsz, h, p, n)}")
    tensors = [x, dt, a_neg, b_mat, c_mat] + (
        [] if state0 is None else [state0])
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"inputs on {[str(t.device) for t in tensors]}")


@functools.lru_cache(maxsize=256)
def flops(b: int, s: int, h: int, p: int, n: int, g: int,
          state0: bool) -> int:
    """Fewest operations of the SSD scan on these inputs
    (``kernel_bench.ssd_flops``): the chunked form at the tile length q
    that minimises them (the form is exact for any q; K4 walks tiles of
    64).  Per tile: C B^T once per group and att (dt x) per head over the
    causal triangle, C S_in (none on the first tile without a state in),
    the state's decay and its update B^T (dt x)."""
    def at(q):
        full, r = divmod(s, q)
        pairs = full * q * (q + 1) // 2 + r * (r + 1) // 2
        carried = 0 if state0 else 1          # the first tile's state is 0
        return (2 * b * pairs * (g * n + h * p)
                + 2 * b * h * n * p * (2 * s - carried * min(q, s))
                + b * h * n * p * (full + (r > 0) - carried))
    return min(at(q) for q in range(1, s + 1))


def work(x, dt, a_neg, b_mat, c_mat, state0=None) -> dict:
    """{"flops", "bytes"} of one call (tensors or anything with ``shape``
    and ``dtype``): ``flops`` above, and x, dt, a_neg, b_mat, c_mat and
    state0 read once, y (x's dtype) and the f32 final state written
    once."""
    def size(t):
        n = t.dtype.itemsize
        for e in t.shape:
            n *= int(e)
        return n
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    ins = [x, dt, a_neg, b_mat, c_mat] + ([] if state0 is None else [state0])
    return {"flops": flops(bsz, s, h, p, n, g, state0 is not None),
            "bytes": sum(size(t) for t in ins) + size(x)
            + 4 * bsz * h * p * n}


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_neg: torch.Tensor,
             b_mat: torch.Tensor, c_mat: torch.Tensor, *, chunk: int,
             state0: Optional[torch.Tensor] = None,
             use_kernel: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, S, H, P]; dt: [B, S, H] (> 0); a_neg: [H] (< 0); b_mat, c_mat:
    [B, S, G, N]; state0: [B, H, P, N] or None.  Returns (y [B, S, H, P] in
    x's dtype, final state [B, H, P, N] float32).  On the card: contiguous
    x, dt, b_mat, c_mat of one dtype (f32 or bf16), x, b_mat and c_mat
    starting on a 16-byte boundary, a_neg and state0 in f32, P and N in
    ``DIMS``."""
    _check_inputs(x, dt, a_neg, b_mat, c_mat, chunk, state0)
    if not use_kernel or not count.on_card(x):
        return ref.ssd_chunked(x, dt, a_neg, b_mat, c_mat, chunk,
                               state0=state0)
    if dist.is_local(x):                # a simulated mesh: one launch a rank
        return dist.per_rank(ssd_scan)(x, dt, a_neg, b_mat, c_mat,
                                       chunk=chunk, state0=state0)
    check_no_grad("ssd_scan (K4)", x, dt, a_neg, b_mat, c_mat, state0)
    if x.dtype not in DTYPES or not (x.dtype == dt.dtype == b_mat.dtype
                                     == c_mat.dtype):
        raise TypeError(f"ssd_scan takes x, dt, b_mat, c_mat all in one of "
                        f"{list(DTYPES)}; got {x.dtype}, {dt.dtype}, "
                        f"{b_mat.dtype}, {c_mat.dtype}")
    for t, name in ((a_neg, "a_neg"), (state0, "state0")):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    if p not in DIMS or n not in DIMS:
        raise ValueError(f"head dim P {p} and state N {n} must be in {DIMS}")
    if bsz > MAX_BATCH:
        raise ValueError(f"batch {bsz} over {MAX_BATCH}")
    for t, name in ((x, "x"), (dt, "dt"), (a_neg, "a_neg"), (b_mat, "b_mat"),
                    (c_mat, "c_mat"), (state0, "state0")):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    fake = count.is_fake(x)
    for t, name in ((x, "x"), (b_mat, "b_mat"), (c_mat, "c_mat")):
        if not fake and t.data_ptr() % ALIGN:
            raise ValueError(f"{name} must start on a {ALIGN}-byte boundary")
    y = torch.empty_like(x)
    state = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    if fake:                    # a dry-run: counted, never launched
        count.add_kernel("ssd_scan", work(x, dt, a_neg, b_mat, c_mat, state0))
        return y, state
    name = f"ssd_scan_{DTYPES[x.dtype]}"
    err = getattr(build.library("ssd_scan"), name)(
        x.data_ptr(), dt.data_ptr(), a_neg.data_ptr(), b_mat.data_ptr(),
        c_mat.data_ptr(), None if state0 is None else state0.data_ptr(),
        y.data_ptr(), state.data_ptr(), bsz, s, h, g, p, n,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, name)
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0
