"""Kernel K2 for Hopper: the unfused flat OTA aggregation, one launch per
round for the whole fleet.

    out[c, d] = sum_m g[c, m, d] s[c, m] + ns[c] z[c, d]

accumulated in f32 and cast to g's dtype on store.  Replaces
``src/repro/kernels/ota_aggregate.py::ota_aggregate_pallas`` (body
``_kernel``), which the reference vmaps over its [K, S] cells; here the
cell axis C is explicit.  CUDA C++ in ``csrc/ota_kernels.cu``, templated on
g's dtype (f32, bf16); the main path hands it f32, since quantized wires
are dequantized first.

Bound: bytes.  At the main-path shape (C = 7, N = 10, D = 814,090, f32) it
reads g (227.9 MB) and z (22.8 MB) and writes out (22.8 MB): 273.5 MB,
81.7 us at the H100 SXM data sheet's 3.35 TB/s.  Design as K1's: runs of
one 16-byte vector of g (and of out) per thread on a (D blocks, C) grid,
16-byte loads of every stream realigned across lanes by warp shuffles,
16-byte stores, the ragged ends one element a thread; the result is
bitwise equal to the plain version.

The plain version is ``ref.ota_aggregate_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.round_step import MAX_CELLS, _expect

G_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def ota_aggregate(g: torch.Tensor, s: torch.Tensor, z: torch.Tensor,
                  ns: torch.Tensor) -> torch.Tensor:
    """Launch K2.  g: [C, N, D] f32/bf16; s: [C, N] f32; z: [C, D] f32;
    ns: [C] f32; all contiguous on one CUDA device.  Returns [C, D] in g's
    dtype."""
    if not g.is_cuda:
        raise ValueError("ota_aggregate launches a CUDA kernel; got a tensor "
                         f"on {g.device} (the plain version is "
                         "kernels.ref.ota_aggregate_ref)")
    if g.dim() != 3 or g.dtype not in G_DTYPES:
        raise TypeError(f"g must be [C, N, D] in {list(G_DTYPES)}, got "
                        f"{tuple(g.shape)} {g.dtype}")
    c, n, d = g.shape
    if not 0 < c <= MAX_CELLS:
        raise ValueError(f"cell count {c} not in [1, {MAX_CELLS}]")
    _expect(g, "g", (c, n, d), g.dtype, g.device)
    f32 = torch.float32
    for t, name, shape in ((s, "s", (c, n)), (z, "z", (c, d)),
                           (ns, "ns", (c,))):
        _expect(t, name, shape, f32, g.device)
    out = torch.empty((c, d), dtype=g.dtype, device=g.device)
    name = f"ota_aggregate_{G_DTYPES[g.dtype]}"
    err = getattr(build.library("ota_kernels"), name)(
        g.data_ptr(), s.data_ptr(), z.data_ptr(), ns.data_ptr(),
        out.data_ptr(), c, n, d,
        torch.cuda.current_stream(g.device).cuda_stream)
    build.check(err, name)
    ota_aggregate.launches += 1
    return out


ota_aggregate.launches = 0
