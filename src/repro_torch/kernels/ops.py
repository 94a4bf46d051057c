"""Wrappers around the OTA kernels: uplink quantization, ravel/unravel and
dispatch (``repro.kernels.ops``).

Everything here is plain torch, as the reference's wrappers are jnp outside
Pallas.  The pytree functions ravel a dict of leaves with leading
[C, N, ...] (gradients) or [C, ...] (parameters) axes in raveling order
(sorted keys: ``b1, b2, w1, w2`` for the MLP) into one [C, N, D] / [C, D]
matrix and run ONE kernel launch for the whole fleet.

Dispatch: a CUDA tensor goes to the CUDA kernel (which raises if it cannot
build or launch); a CPU tensor goes to the plain version in ``ref``.
``use_kernel=False`` forces the plain version on the card too, so that a
run can hold the kernels against it on the same draws.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ota_aggregate as oa
from repro_torch.kernels import ref
from repro_torch.kernels import round_step as rs

UPLINK_DTYPES = ("f32", "bf16", "int8")

# int8 symmetric quantization: values map to [-127, 127] (the -128 code is
# unused so the grid is symmetric around zero)
INT8_LEVELS = 127.0


def _kernel_for(t: torch.Tensor, use_kernel: Optional[bool]) -> bool:
    if use_kernel is None:
        return t.is_cuda
    if use_kernel and not t.is_cuda:
        raise ValueError(f"use_kernel=True needs CUDA tensors, got {t.device}")
    return bool(use_kernel)


def quantize_uplink(g: torch.Tensor, uplink_dtype: str):
    """Device-side uplink quantization of the [C, N, D] precoded gradients.

    Returns ``(wire, q_scale)``:
      f32   passthrough (``wire is g``), q_scale None.
      bf16  round-to-nearest-even cast, q_scale None.
      int8  per-(cell, device) symmetric scale over the device's whole
            raveled gradient, scale = max(amax, f32.tiny) / 127, wire =
            round-half-to-even(g / scale) clipped to [-127, 127];
            q_scale [C, N] f32.
    """
    if uplink_dtype == "f32":
        return g, None
    if uplink_dtype == "bf16":
        return g.to(torch.bfloat16), None
    if uplink_dtype == "int8":
        gf = g.float()
        amax = torch.amax(torch.abs(gf), dim=-1)
        scale = torch.clamp(amax, min=torch.finfo(torch.float32).tiny) \
            / INT8_LEVELS
        q = torch.round(gf / scale[..., None])
        return torch.clamp(q, -INT8_LEVELS, INT8_LEVELS).to(torch.int8), scale
    raise ValueError(f"uplink_dtype must be one of {UPLINK_DTYPES}, "
                     f"got {uplink_dtype!r}")


def dequantize_uplink(wire: torch.Tensor, q_scale) -> torch.Tensor:
    """Receiver-side inverse of ``quantize_uplink`` (always f32 out)."""
    gf = wire.float()
    if q_scale is None:
        return gf
    return gf * q_scale[..., None].float()


def ravel(tree: dict, lead: int) -> torch.Tensor:
    """Concatenate the leaves in raveling order, keeping ``lead`` leading
    axes: [C, N, ...] leaves with lead=2 give [C, N, D]."""
    return torch.cat([tree[k].reshape(tree[k].shape[:lead] + (-1,))
                      for k in sorted(tree)], dim=lead)


def unravel(flat: torch.Tensor, like: dict, lead: int) -> dict:
    """Split ``flat`` [..., D] back into ``like``'s leaves (shapes past the
    first ``lead`` axes), cast to each leaf's dtype."""
    out, off = {}, 0
    head = tuple(flat.shape[:-1])
    for k in sorted(like):
        shape = tuple(like[k].shape[lead:])
        size = 1
        for v in shape:
            size *= v
        out[k] = flat[..., off:off + size].reshape(head + shape).to(
            like[k].dtype)
        off += size
    return out


def ota_round_step_flat(wire: torch.Tensor, s: torch.Tensor, z: torch.Tensor,
                        noise_scale: torch.Tensor, params: torch.Tensor,
                        eta: torch.Tensor, q_scale=None, *,
                        use_kernel: Optional[bool] = None) -> torch.Tensor:
    """K1 on flat [C, N, D] wire / [C, D] params, or its plain version."""
    if _kernel_for(wire, use_kernel):
        qs = torch.ones_like(s, dtype=torch.float32) if q_scale is None \
            else q_scale.float().contiguous()
        return rs.ota_round_step(wire.contiguous(), qs, s.float().contiguous(),
                                 z.float().contiguous(),
                                 noise_scale.float().contiguous(),
                                 params.contiguous(),
                                 eta.float().contiguous())
    return ref.ota_round_step_ref(wire, s, z, noise_scale, params, eta,
                                  q_scale=q_scale)


def ota_aggregate_flat(g: torch.Tensor, s: torch.Tensor, z: torch.Tensor,
                       noise_scale: torch.Tensor, *,
                       use_kernel: Optional[bool] = None) -> torch.Tensor:
    """K2 on flat [C, N, D] gradients, or its plain version."""
    if _kernel_for(g, use_kernel):
        return oa.ota_aggregate(g.contiguous(), s.float().contiguous(),
                                z.float().contiguous(),
                                noise_scale.float().contiguous())
    return ref.ota_aggregate_ref(g, s, z, noise_scale)


def ota_round_step_pytree(stacked: dict, s: torch.Tensor,
                          noise_scale: torch.Tensor, z: torch.Tensor,
                          params: dict, eta: torch.Tensor, *,
                          uplink_dtype: str = "f32",
                          use_kernel: Optional[bool] = None) -> dict:
    """The whole flat-path round tail as ONE launch for the fleet.

    ``stacked``: gradient leaves [C, N, ...]; ``params``: parameter leaves
    [C, ...]; ``s`` [C, N]; ``noise_scale``, ``eta`` [C]; ``z`` [C, D], the
    receiver noise already raveled in leaf order (the draws provider draws
    it leaf by leaf, as the reference keys it).  Devices quantize per
    ``uplink_dtype``; the kernel dequantizes, f32-accumulates
    sum_m s_m g_m + noise_scale z and applies p - eta ghat.  Returns the
    updated parameter dict.
    """
    g = ravel(stacked, 2)
    p_flat = ravel(params, 1).float()
    wire, q_scale = quantize_uplink(g, uplink_dtype)
    out = ota_round_step_flat(wire, s, z, noise_scale.to(g.dtype), p_flat,
                              eta.float(), q_scale, use_kernel=use_kernel)
    return unravel(out, params, 1)


def ota_aggregate_pytree(stacked: dict, s: torch.Tensor,
                         noise_scale: torch.Tensor, z: torch.Tensor, *,
                         uplink_dtype: str = "f32",
                         use_kernel: Optional[bool] = None) -> dict:
    """Flat OTA aggregation over the whole gradient dict in one launch.

    ``stacked`` leaves are [C, N, ...]; returns the aggregated leaves
    [C, ...].  A quantized uplink round-trips through ``quantize_uplink`` /
    ``dequantize_uplink`` first, so the kernel always sees g's own dtype
    (f32 on the main path) -- the same wire values as the fused path.
    """
    g = ravel(stacked, 2)
    dtype = g.dtype
    if uplink_dtype != "f32":
        wire, q_scale = quantize_uplink(g, uplink_dtype)
        g = dequantize_uplink(wire, q_scale).to(dtype)
    out = ota_aggregate_flat(g, s, z, noise_scale.to(dtype),
                             use_kernel=use_kernel)
    return unravel(out, stacked, 2)
