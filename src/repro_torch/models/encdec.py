"""Encoder-decoder backbone of the port (the SeamlessM4T family).

A copy of ``repro.models.encdec``.  The audio front end (mel spectrogram
and conv feature extractor) is a stub in the reference too: the encoder
takes precomputed frame embeddings [B, S_frames, D].  The encoder runs
bidirectional ``enc_attn`` blocks, the decoder causal blocks with
cross-attention over the encoder's output (``memory``).  The reference
stacks each side's layers under ``lax.scan`` with ``jax.checkpoint``; the
port keeps one parameter entry per layer (``enc_layers``,
``dec_layers``) and runs a Python loop over them, as
``models.transformer`` does.

Every prefill attention goes through K3: the encoder's self-attention
and the cross-attention in its non-causal mode, the decoder's
self-attention causal.  Decode steps stay plain PyTorch.  The train loss
(``seq2seq_loss``) runs the plain attention (``use_kernel=False``), which
autograd differentiates, as ``transformer.lm_loss`` does: past
Sq * Sk = 2048^2 its blocked form (``kernels.ref.grouped_attention_blocked``),
which, unlike the reference's, masks the padded keys of a ragged last
block in the encoder's and the cross-attention's non-causal mode too.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (embed, embedding_def, rmsnorm,
                                       rmsnorm_def, unembed, unembed_def)

ENC_SIG = ("enc_attn", "dense")
DEC_SIG = ("attn", "dense")


def encdec_defs(cfg: ModelConfig) -> dict:
    """Parameter definitions, in the reference's order: ``enc_layers``
    (the reference's ``enc_scan``), ``enc_ln_f``, ``embed`` (the decoder's
    tokens), ``dec_layers`` (``dec_scan``, blocks with cross-attention),
    ``ln_f``, ``unembed``."""
    tfm.check_supported(cfg)
    return {
        "enc_layers": [tfm.layer_def(cfg, ENC_SIG)
                       for _ in range(cfg.encoder_layers)],
        "enc_ln_f": rmsnorm_def(cfg.d_model, cfg.param_dtype),
        "embed": embedding_def(cfg),
        "dec_layers": [tfm.layer_def(cfg, DEC_SIG, cross=True)
                       for _ in range(cfg.n_layers)],
        "ln_f": rmsnorm_def(cfg.d_model, cfg.param_dtype),
        "unembed": unembed_def(cfg),
    }


def encode(params, frames: torch.Tensor, cfg: ModelConfig, *,
           use_kernel: bool = True) -> torch.Tensor:
    """frames: [B, S_frames, D] stub front-end embeddings (any float dtype,
    cast to the compute dtype) -> memory [B, S_frames, D]."""
    x = frames.to(cfg.compute_dtype)
    for p in params["enc_layers"]:
        x, _, _ = tfm.apply_layer(p, x, cfg, ENC_SIG, use_kernel=use_kernel)
    return rmsnorm(params["enc_ln_f"], x, cfg.norm_eps)


def decode_train(params, memory: Optional[torch.Tensor], tokens: torch.Tensor,
                 cfg: ModelConfig, caches: Optional[list] = None, *,
                 cross_caches: Optional[list] = None,
                 use_kernel: bool = True):
    """Teacher-forced decoder: tokens [B, S] -> logits [B, S, V] f32.

    With ``caches`` (per-layer self-attention KV), also fills them in
    place and returns (logits, caches): the serving prefill.  With
    ``cross_caches`` (``build_cross_caches`` of ``memory``), the layers
    read the encoder's K and V from them instead of projecting ``memory``
    again: the same product on the same operands.
    """
    h = _decode_hidden(params, memory, tokens, cfg, caches,
                       cross_caches=cross_caches, use_kernel=use_kernel)
    logits = unembed(params["unembed"], h, cfg)
    return logits if caches is None else (logits, caches)


def _decode_hidden(params, memory: Optional[torch.Tensor],
                   tokens: torch.Tensor, cfg: ModelConfig,
                   caches: Optional[list] = None, *,
                   cross_caches: Optional[list] = None,
                   use_kernel: bool = True) -> torch.Tensor:
    """``decode_train`` up to the final normed hidden state [B, S, D]."""
    x = embed(params["embed"], tokens, cfg.compute_dtype)
    for i, p in enumerate(params["dec_layers"]):
        x, _, _ = tfm.apply_layer(
            p, x, cfg, DEC_SIG, cache=None if caches is None else caches[i],
            memory=memory,
            cross_cache=None if cross_caches is None else cross_caches[i],
            use_kernel=use_kernel)
    return rmsnorm(params["ln_f"], x, cfg.norm_eps)


def seq2seq_loss(params, frames: torch.Tensor, tokens: torch.Tensor,
                 cfg: ModelConfig,
                 sample_weights: Optional[torch.Tensor] = None,
                 use_kernel: bool = False) -> torch.Tensor:
    """Encoder frames [B, S_frames, D] + the teacher-forced next-token
    loss of the decoder over tokens [B, S + 1], with the per-sample
    weights of ``transformer.softmax_xent``, its logits taken by
    ``transformer.head_xent``.  ``use_kernel=False`` (the default, as a
    train step differentiates it) runs the plain attention, at any length:
    past Sq * Sk = 2048^2 in its blocked form."""
    memory = encode(params, frames, cfg, use_kernel=use_kernel)
    h = _decode_hidden(params, memory, tokens[:, :-1], cfg,
                       use_kernel=use_kernel)
    return tfm.head_xent(params["unembed"], h, tokens[:, 1:], cfg,
                         sample_weights)


# ---------------------------------------------------------------------------
# Serving path
# ---------------------------------------------------------------------------

def init_decode_caches(cfg: ModelConfig, batch: int, max_len: int,
                       device: torch.device) -> list:
    """One zero self-attention KV cache per decoder layer."""
    return [attn_mod.init_kv_cache(cfg, batch, max_len, "attn", device)
            for _ in range(cfg.n_layers)]


def build_cross_caches(params, memory: torch.Tensor,
                       cfg: ModelConfig) -> list:
    """Per decoder layer, the encoder-side K and V over ``memory``."""
    return [attn_mod.cross_cache(p["cross"], memory, cfg)
            for p in params["dec_layers"]]


def decode_step(params, caches: list, cross_caches: list,
                token: torch.Tensor, pos: int, cfg: ModelConfig):
    """One decode step: token [B, 1] at position ``pos`` -> (logits
    [B, 1, V] f32, caches); the self caches are written in place, the
    cross caches only read."""
    x = embed(params["embed"], token, cfg.compute_dtype)
    for i, p in enumerate(params["dec_layers"]):
        x, _, _ = tfm.apply_layer(p, x, cfg, DEC_SIG, pos_offset=pos,
                                  cache=caches[i], decode=True,
                                  cross_cache=cross_caches[i])
    logits = unembed(params["unembed"], rmsnorm(params["ln_f"], x,
                                                cfg.norm_eps), cfg)
    return logits, caches
