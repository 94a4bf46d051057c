"""Serving steps: prefill and one greedy decode step.

The serving half of ``repro.launch.steps``; the OTA-FL train step waits
for the LM train path (ROADMAP.md).  PyTorch runs eagerly, so the steps
are plain closures over the bundle (the reference ``jax.jit``s them).
"""
from __future__ import annotations

import torch

from repro_torch.models.registry import ModelBundle


def make_prefill_step(bundle: ModelBundle):
    def prefill_step(params, inputs, caches):
        return bundle.prefill(params, inputs, caches)
    return prefill_step


def make_serve_step(bundle: ModelBundle):
    """One decode step: token [B, 1] against the KV caches (updated in
    place); returns the greedy next token [B, 1] and the caches."""
    def serve_step(params, caches, token, pos: int):
        logits, caches = bundle.decode(params, caches, token, pos)
        next_token = torch.argmax(logits[:, -1, :], dim=-1)[:, None]
        return next_token, caches
    return serve_step
