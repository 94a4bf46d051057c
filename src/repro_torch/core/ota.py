"""OTA aggregation operators (paper eqs. (3)-(6)), ported from
``repro.core.ota``.

Every tensor carries a leading cell axis C (one cell per (scheme, seed) of
the fleet); gradients add a device axis: [C, N, ...].  Random draws are
inputs, never made here: the fleet's draws provider hands each round its
fading ``h`` and its receiver noise ``z`` (raveled in leaf order).  Every
scheme reduces, per round, to ``(s [C, N], noise_scale [C])``:

    g_hat = sum_m s_m * g_m  +  noise_scale * z,     z ~ N(0, I_d)
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops as kops

UPLINK_DTYPES = kops.UPLINK_DTYPES


def draw_fading(gains: torch.Tensor, rows: int,
                generator: torch.Generator) -> torch.Tensor:
    """h_m ~ CN(0, Lambda_m): complex64 [rows, N] (real, then imaginary
    parts drawn from ``generator``)."""
    scale = torch.sqrt(gains.float() / 2.0)
    shape = (rows,) + tuple(gains.shape)
    re = torch.randn(shape, generator=generator, device=gains.device) * scale
    im = torch.randn(shape, generator=generator, device=gains.device) * scale
    return torch.complex(re, im)


def add_receiver_noise(tree: dict, noise_scale: torch.Tensor,
                       z: torch.Tensor) -> dict:
    """g + noise_scale * z per leaf; z is the raveled noise [C, D]."""
    zt = kops.unravel(z, tree, 1)
    out = {}
    for k, leaf in tree.items():
        ns = noise_scale.reshape((-1,) + (1,) * (leaf.dim() - 1))
        out[k] = leaf + (ns * zt[k]).to(leaf.dtype)
    return out


def weighted_sum(stacked: dict, s: torch.Tensor) -> dict:
    """sum_m s_m * g_m over the device axis of every [C, N, ...] leaf.

    Accumulates in float32 and casts on write: casting ``s`` to a
    low-precision leaf dtype first would lose coefficient precision.
    """
    out = {}
    for k, leaf in stacked.items():
        w = s.float().reshape(s.shape + (1,) * (leaf.dim() - 2))
        out[k] = torch.sum(w * leaf.float(), dim=1).to(leaf.dtype)
    return out


def apply_round_coeffs(stacked_grads: dict, s: torch.Tensor,
                       noise_scale: torch.Tensor, z: torch.Tensor,
                       flat: bool = False, uplink_dtype: str = "f32",
                       use_kernel: Optional[bool] = None) -> dict:
    """Aggregate with precomputed per-round coefficients.

    flat=False: the per-leaf path (the reference's oracle).
    flat=True:  ravel once and run one flat aggregation for the fleet
                (kernel K2 on CUDA, its plain version on the CPU).
    ``uplink_dtype`` (flat only) quantizes the wire before aggregation.
    """
    if flat:
        return kops.ota_aggregate_pytree(stacked_grads, s, noise_scale, z,
                                         uplink_dtype=uplink_dtype,
                                         use_kernel=use_kernel)
    if uplink_dtype != "f32":
        raise ValueError("quantized uplink requires the flat aggregation "
                         f"path (flat=True), got uplink_dtype={uplink_dtype!r}")
    return add_receiver_noise(weighted_sum(stacked_grads, s), noise_scale, z)


def fused_round_step(stacked_grads: dict, s: torch.Tensor,
                     noise_scale: torch.Tensor, z: torch.Tensor,
                     params: dict, eta: torch.Tensor,
                     uplink_dtype: str = "f32",
                     use_kernel: Optional[bool] = None) -> dict:
    """The whole flat-path round tail -- quantized uplink, superposition,
    receiver noise, SGD step -- as one launch (kernel K1 on CUDA, its plain
    version on the CPU); returns the updated params."""
    return kops.ota_round_step_pytree(stacked_grads, s, noise_scale, z,
                                      params, eta, uplink_dtype=uplink_dtype,
                                      use_kernel=use_kernel)
