"""Kernel K1 for Hopper: the fused OTA round step, one launch per round for
the whole fleet.

    ghat[c, d] = sum_m (g[c, m, d] qs[c, m]) s[c, m] + ns[c] z[c, d]
    out[c, d]  = p[c, d] - eta[c] ghat[c, d]

Replaces ``src/repro/kernels/round_step.py::ota_round_step_pallas`` (body
``_kernel``), which the reference vmaps over its [K, S] cells; here the
cell axis C is explicit.  CUDA C++ in ``csrc/ota_kernels.cu``, templated on
the wire dtype (f32, bf16, int8).

Bound: bytes.  At the main-path shape (C = 7, N = 10, D = 814,090, f32
wire) it reads g (227.9 MB), z and p (22.8 MB each) and writes out
(22.8 MB): 296.3 MB, 88.5 us at the H100 SXM data sheet's 3.35 TB/s; 2N+3
flops per output element is far below the card's ridge point.  Design: one
thread per output element on a (D blocks, C) grid, coalesced loads, the
cell's coefficients in shared memory, an f32 loop over the devices with
the reference's association, the ragged tail of D masked (see the source).

The plain version is ``ref.ota_round_step_ref``; ``kernels.ops`` picks
between the two by the tensors' device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

WIRE_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16",
               torch.int8: "int8"}
MAX_CELLS = 65535              # gridDim.y


def _expect(t: torch.Tensor, name: str, shape: tuple, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ota_round_step(g: torch.Tensor, qs: torch.Tensor, s: torch.Tensor,
                   z: torch.Tensor, ns: torch.Tensor, params: torch.Tensor,
                   eta: torch.Tensor) -> torch.Tensor:
    """Launch K1.  g: [C, N, D] f32/bf16/int8; qs, s: [C, N] f32; z, params:
    [C, D] f32; ns, eta: [C] f32; all contiguous on one CUDA device.
    Returns the updated params [C, D] f32."""
    if not g.is_cuda:
        raise ValueError("ota_round_step launches a CUDA kernel; got a "
                         f"tensor on {g.device} (the plain version is "
                         "kernels.ref.ota_round_step_ref)")
    if g.dim() != 3 or g.dtype not in WIRE_DTYPES:
        raise TypeError(f"g must be [C, N, D] in {list(WIRE_DTYPES)}, got "
                        f"{tuple(g.shape)} {g.dtype}")
    c, n, d = g.shape
    if not 0 < c <= MAX_CELLS:
        raise ValueError(f"cell count {c} not in [1, {MAX_CELLS}]")
    _expect(g, "g", (c, n, d), g.dtype, g.device)
    f32 = torch.float32
    for t, name, shape in ((qs, "qs", (c, n)), (s, "s", (c, n)),
                           (z, "z", (c, d)), (params, "params", (c, d)),
                           (ns, "ns", (c,)), (eta, "eta", (c,))):
        _expect(t, name, shape, f32, g.device)
    out = torch.empty_like(params)
    name = f"ota_round_step_{WIRE_DTYPES[g.dtype]}"
    err = getattr(build.library(), name)(
        g.data_ptr(), qs.data_ptr(), s.data_ptr(), z.data_ptr(),
        ns.data_ptr(), params.data_ptr(), eta.data_ptr(), out.data_ptr(),
        c, n, d, torch.cuda.current_stream(g.device).cuda_stream)
    build.check(err, name)
    ota_round_step.launches += 1
    return out


ota_round_step.launches = 0
