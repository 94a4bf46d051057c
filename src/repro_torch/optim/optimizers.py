"""Gradient clipping for the FL clients (``repro.optim.optimizers``)."""
from __future__ import annotations

import torch


def clip_by_global_norm(grads: dict, max_norm: float):
    """Scale grads so that the global l2 norm is <= max_norm.

    Enforces Assumption 2 (||g_m|| <= G_max).  The norm is taken over all
    leaves in float32, in raveling order; scale = min(1, max_norm /
    max(norm, 1e-12)).  Returns (clipped grads, pre-clip norm).
    """
    sq = sum(torch.sum(torch.square(grads[k].float())) for k in sorted(grads))
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: (g * scale).to(g.dtype) for k, g in grads.items()}, norm
