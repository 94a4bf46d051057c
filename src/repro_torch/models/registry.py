"""Model bundle: one interface over the port's language models.

A copy of ``repro.models.registry``: the decoder bundle, for the dense
GQA decoders, Mamba-2, RecurrentGemma, MoE and MLA alike, and the
encoder-decoder
bundle (seamless-m4t-medium).  A ``ModelBundle`` holds one config and its
device, and exposes ``init``, ``loss`` (the next-token loss with
per-sample weights, which the train step differentiates), ``prefill``,
``decode``, ``abstract`` (the dry-run's fake parameters) and
``init_caches`` (per layer, a KV cache, an MLA latent
cache or a recurrent state; the encoder-decoder's decoder self caches).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import (ParamTree, abstract_params,
                                      init_param_tree, tree_param_count)


@dataclasses.dataclass
class ModelBundle:
    cfg: ModelConfig
    defs: Any
    device: torch.device
    # (params, tokens [B, S + 1], sample_weights=None, use_kernel=False)
    # -> scalar (enc-dec: the batch is (frames, tokens)); params may be a
    # ParamTree or its ``trainable`` view
    loss: Callable
    prefill: Callable       # (params, inputs, caches) -> (logits, caches)
    decode: Callable        # (params, caches, token, pos) -> (logits, caches)
    init_caches: Callable   # (batch, max_len) -> per-layer caches or states
    num_params: int = 0

    def init(self, seed: int) -> ParamTree:
        """Parameters drawn with the reference's init laws from a generator
        on the bundle's device, seeded with ``seed`` (not JAX's stream:
        ``lm_params_from_jax`` carries the reference's weights across)."""
        return init_param_tree(self.defs, seed, self.device)

    def abstract(self) -> ParamTree:
        """Empty fakes of the parameters' shapes and dtypes on the bundle's
        device, for the dry-run (inside ``launch.count.fake_mode``)."""
        return abstract_params(self.defs, self.device)


def _decoder_bundle(cfg: ModelConfig, device: torch.device, tp: int,
                    dp: int) -> ModelBundle:
    defs = tfm.model_defs(cfg, tp, dp)

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


def _encdec_bundle(cfg: ModelConfig, device: torch.device, tp: int,
                   dp: int) -> ModelBundle:
    """Inputs are (frames [B, S_frames, D], decoder tokens [B, S]); the
    caches the decoder's self caches, then with the prefill's cross
    caches as the pair (self, cross)."""
    defs = encdec_mod.encdec_defs(cfg, tp, dp)

    def loss(params, batch, sample_weights=None, use_kernel=False):
        frames, tokens = batch
        return encdec_mod.seq2seq_loss(params, frames, tokens, cfg,
                                       sample_weights=sample_weights,
                                       use_kernel=use_kernel)

    @torch.no_grad()
    def prefill(params, inputs, caches):
        """Returns (logits, (self caches, cross caches)).  The reference
        projects the memory's K and V twice (in each layer and again for
        the cross caches); the port builds the cross caches once and the
        decoder reads them."""
        frames, dec_tokens = inputs
        memory = encdec_mod.encode(params, frames, cfg)
        cross = encdec_mod.build_cross_caches(params, memory, cfg)
        logits, self_c = encdec_mod.decode_train(
            params, memory, dec_tokens, cfg, caches=caches,
            cross_caches=cross)
        return logits, (self_c, cross)

    @torch.no_grad()
    def decode(params, caches, token, pos: int):
        self_c, cross_c = caches
        logits, self_c = encdec_mod.decode_step(params, self_c, cross_c,
                                                token, pos, cfg)
        return logits, (self_c, cross_c)

    def init_caches(batch: int, max_len: int):
        return encdec_mod.init_decode_caches(cfg, batch, max_len, device)

    return ModelBundle(cfg=cfg, defs=defs, device=device, loss=loss,
                       prefill=prefill, decode=decode,
                       init_caches=init_caches,
                       num_params=tree_param_count(defs))


def build_bundle(cfg: ModelConfig, device: DeviceLike = None, tp: int = 16,
                 dp: int = 16) -> ModelBundle:
    """The bundle of ``cfg`` on ``device`` (None: the CUDA card, which must
    be there; ``"cpu"`` runs every kernel's plain version), its defs'
    sharding specs for a model axis of ``tp`` and a data axis of ``dp``
    (the reference's defaults: its (16, 16) pod mesh)."""
    make = _encdec_bundle if cfg.is_enc_dec else _decoder_bundle
    return make(cfg, resolve_device(device), tp, dp)
