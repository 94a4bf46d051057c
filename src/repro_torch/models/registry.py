"""Model bundle: one interface over the port's language models.

A copy of the decoder bundle of ``repro.models.registry``, for the dense
GQA decoders, Mamba-2 and RecurrentGemma alike.  A ``ModelBundle`` holds one config and
its device, and exposes ``init``, ``loss`` (the next-token loss with
per-sample weights, which the train step differentiates), ``prefill``,
``decode`` and ``init_caches`` (per layer, a KV cache or a recurrent
state).  The encoder-decoder bundle waits for its family (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import (ParamTree, init_param_tree,
                                      tree_param_count)


@dataclasses.dataclass
class ModelBundle:
    cfg: ModelConfig
    defs: Any
    device: torch.device
    # (params, tokens [B, S + 1], sample_weights=None, use_kernel=False)
    # -> scalar; params may be a ParamTree or its ``trainable`` view
    loss: Callable
    prefill: Callable       # (params, tokens, caches) -> (logits, caches)
    decode: Callable        # (params, caches, token, pos) -> (logits, caches)
    init_caches: Callable   # (batch, max_len) -> per-layer caches or states
    num_params: int = 0

    def init(self, seed: int) -> ParamTree:
        """Parameters drawn with the reference's init laws from a generator
        on the bundle's device, seeded with ``seed`` (not JAX's stream:
        ``lm_params_from_jax`` carries the reference's weights across)."""
        return init_param_tree(self.defs, seed, self.device)


def _decoder_bundle(cfg: ModelConfig, device: torch.device) -> ModelBundle:
    defs = tfm.model_defs(cfg)

    def loss(params, tokens, sample_weights=None, use_kernel=False):
        return tfm.lm_loss(params, tokens, cfg, sample_weights=sample_weights,
                           use_kernel=use_kernel)

    @torch.no_grad()
    def prefill(params, tokens, caches):
        return tfm.forward(params, tokens, cfg, caches=caches)

    @torch.no_grad()
    def decode(params, caches, token, pos: int):
        return tfm.forward(params, token, cfg, pos_offset=pos, caches=caches,
                           decode=True)

    def init_caches(batch: int, max_len: int):
        return tfm.init_caches(cfg, batch, max_len, device)

    return ModelBundle(cfg=cfg, defs=defs, device=device, loss=loss,
                       prefill=prefill, decode=decode,
                       init_caches=init_caches,
                       num_params=tree_param_count(defs))


def build_bundle(cfg: ModelConfig, device: DeviceLike = None) -> ModelBundle:
    """The bundle of ``cfg`` on ``device`` (None: the CUDA card, which must
    be there; ``"cpu"`` runs every kernel's plain version)."""
    if cfg.is_enc_dec:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder bundle is not ported to "
            "repro_torch yet (see ROADMAP.md)")
    return _decoder_bundle(cfg, resolve_device(device))
