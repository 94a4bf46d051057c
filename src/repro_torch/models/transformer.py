"""Transformer blocks of the port, and its decoder-only models: the dense
GQA decoders, Mamba-2, RecurrentGemma, MoE, DeepSeek-V3 (MLA and MTP) and
their hybrids (the encoder-decoder assembles the same blocks in
``models.encdec``).

A copy of ``repro.models.transformer``.  The reference groups repeating
layers under ``lax.scan`` over stacked parameters with
``jax.checkpoint``; the port keeps one parameter entry per layer and runs
a Python loop over them.  The reference's sharding hints are no-ops on one
card and are dropped.  Mixers: attn | swa | local (GQA, causal), enc_attn
(GQA, bidirectional), ssd (Mamba-2) and rglru (RG-LRU); with
``attn_kind="mla"`` every attention kind is MLA (``attention.mla_apply``),
as in the reference; a block built
with ``cross=True`` adds cross-attention over the encoder's memory after
its mixer; FFN: dense (swiglu | geglu | gelu), MoE (``models.moe``) from
layer ``moe_first_dense`` on, or none after an ssd mixer when
``ffn_kind="none"`` (mamba2).  Inputs are token ids, or with
``input_mode="frames"`` embeddings, cast to the compute dtype.  With
``mtp_depth`` the model holds the reference's one multi-token-prediction
module (``mtp``: a projection of [final hidden, next token's embedding],
one dense attention block, a norm; it shares the unembedding), which only
the loss runs.

The loss (``softmax_xent``, ``lm_loss``) is the reference's next-token
cross-entropy, with its per-sample weights, which the OTA-FL train step
rides (``launch.steps``), plus ``router_aux_weight`` times the MoE
layers' load-balance loss summed over the layers, plus
``mtp_loss_weight`` times the MTP head's cross-entropy.  The MTP labels
keep the reference's alignment (``lm_loss``), one position later than its
``mtp_logits`` docstring says.  The train path
differentiates the plain attention and SSD scan (``use_kernel=False``):
the reference trains through its jnp forms, never a Pallas kernel, and
K3 and K4 have no backward.  Past Sq * Sk = 2048^2 the plain attention is
the blocked form (``kernels.ref.grouped_attention_blocked``), whose saved
state is O(S), and every loss head (``lm_loss``'s main and MTP terms,
``encdec.seq2seq_loss``) takes its logits ``HEAD_CHUNK`` tokens at a time
(``head_xent``), so a train sequence of any length fits the card as far
as its layers do.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (embed, embedding_def, mlp, mlp_def,
                                       rmsnorm, rmsnorm_def, unembed,
                                       unembed_def)
from repro_torch.models.param import ParamDef

GQA_KINDS = ("attn", "swa", "local", "enc_attn")
MIXER_KINDS = GQA_KINDS + ("ssd", "rglru")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port does not run yet (ROADMAP.md)."""
    missing = []
    if cfg.attn_kind not in ("gqa", "mla"):
        missing.append(f"{cfg.attn_kind} attention")
    if cfg.input_mode not in ("tokens", "frames"):
        missing.append(f"{cfg.input_mode} inputs")
    missing += [f"{k} mixer" for k in sorted(set(cfg.block_pattern))
                if k not in MIXER_KINDS]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported to repro_torch "
            "yet (see ROADMAP.md, modules to port)")


def layer_sigs(cfg: ModelConfig) -> list:
    """Per-layer (kind, ffn), in execution order: the reference's lead,
    scan groups and tail flattened; an ssd mixer has no FFN when
    ``ffn_kind="none"``, a layer from ``moe_first_dense`` on of an MoE
    config has an MoE FFN."""
    def ffn(i, kind):
        if kind == "ssd" and cfg.ffn_kind == "none":
            return "none"
        return "moe" if cfg.layer_is_moe(i) else "dense"
    return [(kind, ffn(i, kind))
            for i, kind in enumerate(cfg.block_kinds(cfg.n_layers))]


def layer_def(cfg: ModelConfig, sig: tuple, cross: bool = False) -> dict:
    """One block: the mixer of its kind (every kind in GQA_KINDS has the
    same weights: GQA's, or MLA's with ``attn_kind="mla"``), ``ln_cross``
    and ``cross`` when ``cross`` (a decoder block of the encoder-decoder),
    and ``ln2`` and ``ffn`` (a dense MLP or an MoE) unless its FFN is
    none."""
    kind, ffn = sig
    attn = attn_mod.mla_def if cfg.attn_kind == "mla" else attn_mod.gqa_def
    mixer = {"ssd": ssm_mod.ssd_def, "rglru": rglru_mod.rglru_def}.get(
        kind, attn)
    d = {"ln1": rmsnorm_def(cfg.d_model, cfg.param_dtype),
         "mixer": mixer(cfg)}
    if cross:
        d["ln_cross"] = rmsnorm_def(cfg.d_model, cfg.param_dtype)
        d["cross"] = attn_mod.cross_def(cfg)
    if ffn != "none":
        d["ln2"] = rmsnorm_def(cfg.d_model, cfg.param_dtype)
        d["ffn"] = moe_mod.moe_def(cfg) if ffn == "moe" else mlp_def(cfg)
    return d


def model_defs(cfg: ModelConfig) -> dict:
    """Parameter definitions of a decoder-only LM: ``embed`` (token inputs
    only), one entry per layer in ``layers``, ``ln_f``, ``unembed`` unless
    tied, and ``mtp`` with ``mtp_depth`` (``proj`` [2D, D], ``ln_in``, a
    dense attention ``layer``, ``ln_out``: the reference's one module)."""
    check_supported(cfg)
    defs = {"embed": embedding_def(cfg)} if cfg.input_mode == "tokens" \
        else {}
    defs.update(layers=[layer_def(cfg, sig) for sig in layer_sigs(cfg)],
                ln_f=rmsnorm_def(cfg.d_model, cfg.param_dtype))
    if not cfg.tie_embeddings:
        defs["unembed"] = unembed_def(cfg)
    if cfg.mtp_depth:
        defs["mtp"] = {
            "proj": ParamDef((2 * cfg.d_model, cfg.d_model), init="scaled",
                             fan_in=2 * cfg.d_model, dtype=cfg.param_dtype),
            "ln_in": rmsnorm_def(cfg.d_model, cfg.param_dtype),
            "layer": layer_def(cfg, ("attn", "dense")),
            "ln_out": rmsnorm_def(cfg.d_model, cfg.param_dtype),
        }
    return defs


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device: torch.device) -> list:
    """One cache per layer, in execution order: a KV cache for a GQA
    layer, the latent cache for an MLA layer, the recurrent state for an
    ssd or rglru layer.  An enc_attn layer keeps none: its model prefills
    without caches (the reference raises too)."""
    def one(kind):
        if kind == "enc_attn":
            raise ValueError("an enc_attn layer keeps no cache")
        if kind == "ssd":
            return ssm_mod.init_ssd_state(cfg, batch, device)
        if kind == "rglru":
            return rglru_mod.init_rglru_state(cfg, batch, device)
        if cfg.attn_kind == "mla":
            return attn_mod.init_mla_cache(cfg, batch, max_len, device)
        return attn_mod.init_kv_cache(cfg, batch, max_len, kind, device)
    return [one(kind) for kind, _ in layer_sigs(cfg)]


def apply_layer(p, x: torch.Tensor, cfg: ModelConfig, sig: tuple, *,
                pos_offset: int = 0, cache: Optional[dict] = None,
                decode: bool = False, use_kernel: bool = True,
                memory: Optional[torch.Tensor] = None,
                cross_cache: Optional[dict] = None):
    """One block (pre-norm mixer; pre-norm cross-attention over ``memory``
    or ``cross_cache`` when the block has one and either is given; then
    pre-norm FFN unless none).  Returns (x, cache, aux): aux is the MoE
    FFN's load-balance loss, 0.0 for any other layer."""
    kind, ffn = sig
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind == "ssd":
        mix, cache = ssm_mod.ssd_apply(p["mixer"], h, cfg, state=cache,
                                       decode=decode, use_kernel=use_kernel)
    elif kind == "rglru":       # no kernel: plain PyTorch on every device
        mix, cache = rglru_mod.rglru_apply(p["mixer"], h, cfg, state=cache,
                                           decode=decode)
    elif cfg.attn_kind == "mla":
        mix, cache = attn_mod.mla_apply(p["mixer"], h, cfg,
                                        pos_offset=pos_offset, cache=cache,
                                        decode=decode, use_kernel=use_kernel)
    else:
        mix, cache = attn_mod.gqa_apply(p["mixer"], h, cfg, kind=kind,
                                        pos_offset=pos_offset, cache=cache,
                                        decode=decode, use_kernel=use_kernel)
    x = x + mix
    if "cross" in p and (memory is not None or cross_cache is not None):
        hc = rmsnorm(p["ln_cross"], x, cfg.norm_eps)
        x = x + attn_mod.cross_apply(p["cross"], hc, memory, cfg,
                                     cache=cross_cache, decode=decode,
                                     use_kernel=use_kernel)
    aux = 0.0
    if ffn != "none":
        h2 = rmsnorm(p["ln2"], x, cfg.norm_eps)
        if ffn == "moe":
            y, aux = moe_mod.moe_apply(p["ffn"], h2, cfg)
        else:
            y = mlp(p["ffn"], h2, cfg)
        x = x + y
    return x, cache, aux


def forward_aux(params, tokens: torch.Tensor, cfg: ModelConfig, *,
                pos_offset: int = 0, caches: Optional[list] = None,
                decode: bool = False, use_kernel: bool = True,
                return_hidden: bool = False):
    """tokens: int [B, S], or with ``input_mode="frames"`` embeddings
    [B, S, D].  Returns (logits [B, S, V] float32, caches, aux), as the
    reference's ``forward``: the caches, when given, updated in place; aux
    the MoE layers' load-balance losses summed in execution order (0.0
    without MoE); with ``return_hidden`` also the final normed hidden
    state h [B, S, D] that the logits are taken from (the MTP head's
    input)."""
    h, caches, aux = _hidden_aux(params, tokens, cfg, pos_offset=pos_offset,
                                 caches=caches, decode=decode,
                                 use_kernel=use_kernel)
    logits = unembed(_unembedding(params, cfg), h, cfg)
    return (logits, caches, aux, h) if return_hidden \
        else (logits, caches, aux)


def _hidden_aux(params, tokens: torch.Tensor, cfg: ModelConfig, *,
                pos_offset: int = 0, caches: Optional[list] = None,
                decode: bool = False, use_kernel: bool = True):
    """``forward_aux`` up to the final normed hidden state: (h [B, S, D],
    caches, aux)."""
    x = embed(params["embed"], tokens, cfg.compute_dtype) \
        if cfg.input_mode == "tokens" else tokens.to(cfg.compute_dtype)
    aux = 0.0
    for i, sig in enumerate(layer_sigs(cfg)):
        x, _, layer_aux = apply_layer(
            params["layers"][i], x, cfg, sig, pos_offset=pos_offset,
            cache=None if caches is None else caches[i], decode=decode,
            use_kernel=use_kernel)
        aux = aux + layer_aux
    return rmsnorm(params["ln_f"], x, cfg.norm_eps), caches, aux


def _unembedding(params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


def mtp_logits(params, h: torch.Tensor, tokens: torch.Tensor,
               cfg: ModelConfig, use_kernel: bool = True) -> torch.Tensor:
    """The reference's DeepSeek-V3 MTP head: position i from (h_i,
    emb(tokens[i + 1])).  h: [B, S, D] the final normed hidden state;
    tokens: [B, S].  Returns logits [B, S - 1, V] in float32.  Which label
    position i is trained on is ``lm_loss``'s choice: the reference's
    ``tokens[i + 3]`` of the input."""
    return unembed(_unembedding(params, cfg),
                   _mtp_hidden(params, h, tokens, cfg, use_kernel), cfg)


def _mtp_hidden(params, h: torch.Tensor, tokens: torch.Tensor,
                cfg: ModelConfig, use_kernel: bool = True) -> torch.Tensor:
    """``mtp_logits`` up to the MTP head's normed hidden state
    [B, S - 1, D]."""
    p = params["mtp"]
    ct = cfg.compute_dtype
    emb_next = embed(params["embed"], tokens[:, 1:], ct)
    h_in = rmsnorm(p["ln_in"], h[:, :-1], cfg.norm_eps)
    fused = torch.cat([h_in, emb_next], dim=-1)
    x = fused.to(ct) @ p["proj"].to(ct)
    x, _, _ = apply_layer(p["layer"], x, cfg, ("attn", "dense"),
                          use_kernel=use_kernel)
    return rmsnorm(p["ln_out"], x, cfg.norm_eps)


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, *,
            pos_offset: int = 0, caches: Optional[list] = None,
            decode: bool = False, use_kernel: bool = True):
    """``forward_aux`` without the aux loss, which serving ignores (as the
    reference's serve steps do): (logits, caches)."""
    logits, caches, _ = forward_aux(params, tokens, cfg,
                                    pos_offset=pos_offset, caches=caches,
                                    decode=decode, use_kernel=use_kernel)
    return logits, caches


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, vocab_size: int,
                 sample_weights: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Mean cross-entropy, ignoring label == -1.  logits f32 [B, S, V].

    sample_weights [B] (optional): per-sample loss weights, the mean over
    the samples of w_b times sample b's mean token loss -- the OTA-FL
    weighted loss rides these (``core.ota.per_client_loss_weights``).
    ``vocab_size`` is the padded vocab the logits span (the reference's
    signature; the gather needs no bound).
    """
    return _mean_nll(_token_nll(logits, labels), labels, sample_weights)


def _token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each token's negative log-likelihood in f32, 0 where label == -1."""
    mask = (labels >= 0).float()
    labels_safe = torch.clamp(labels, min=0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels_safe[..., None])[..., 0]
    return (logz - gold) * mask


def _mean_nll(nll: torch.Tensor, labels: torch.Tensor,
              sample_weights: Optional[torch.Tensor]) -> torch.Tensor:
    """``softmax_xent``'s mean of the token losses nll [B, S]."""
    mask = (labels >= 0).float()
    if sample_weights is not None:
        w = sample_weights.float()
        per_sample = torch.sum(nll, dim=-1) / torch.clamp(
            torch.sum(mask, dim=-1), min=1)
        return torch.mean(w * per_sample)
    return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1)


# tokens of one chunk of ``head_xent``
HEAD_CHUNK = 2048


def head_xent(w: torch.Tensor, h: torch.Tensor, labels: torch.Tensor,
              cfg: ModelConfig,
              sample_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``softmax_xent(unembed(w, h, cfg), labels, ...)`` without holding
    the [B, S, V] logits: the unembedding and the token losses are taken
    ``HEAD_CHUNK`` tokens at a time and the same mean is taken over them:
    the same function, each chunk's unembedding a product on fewer rows.
    With more than one chunk, each is checkpointed under autograd (its
    logits recomputed in the backward).  At 4 x 4,096 tokens,
    qwen1.5-0.5b's and recurrentgemma-9b's f32 logits are 10.0 and 16.8 GB
    a copy, and the loss's backward holds several copies at once."""
    def chunk_nll(hc, lc):
        return _token_nll(unembed(w, hc, cfg), lc)
    b, s = labels.shape
    hf, lf = h.reshape(b * s, h.shape[-1]), labels.reshape(b * s)
    starts = range(0, b * s, HEAD_CHUNK)
    recompute = len(starts) > 1 and torch.is_grad_enabled()
    parts = []
    for i in starts:
        args = hf[i:i + HEAD_CHUNK], lf[i:i + HEAD_CHUNK]
        parts.append(checkpoint(chunk_nll, *args, use_reentrant=False)
                     if recompute else chunk_nll(*args))
    return _mean_nll(torch.cat(parts).reshape(b, s), labels, sample_weights)


def lm_loss(params, tokens: torch.Tensor, cfg: ModelConfig, labels=None,
            sample_weights: Optional[torch.Tensor] = None,
            use_kernel: bool = False) -> torch.Tensor:
    """Next-token LM loss over tokens [B, S + 1] (or inputs [B, S] with
    ``labels``).  ``use_kernel=False`` (the train path) runs the plain
    attention and SSD scan, which autograd differentiates; the held-out
    eval passes True under ``torch.no_grad()``, through K3 and K4.  An MoE
    config adds ``router_aux_weight`` times the summed aux loss, then an
    MTP config ``mtp_loss_weight`` times the MTP head's cross-entropy, in
    the reference's order.  The MTP labels are the reference's
    ``labels[:, 2:]``: position i of the head, which reads h_i and
    token i + 1 of the input, is trained on input token i + 3 (the
    reference's docstring says i + 2; the port keeps the reference's
    numbers)."""
    if labels is None:
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
    else:
        inputs = tokens
    h, _, aux = _hidden_aux(params, inputs, cfg, use_kernel=use_kernel)
    w = _unembedding(params, cfg)
    loss = head_xent(w, h, labels, cfg, sample_weights)
    if cfg.moe_num_experts:
        loss = loss + cfg.router_aux_weight * aux
    if cfg.mtp_depth:
        mtp_labels = labels[:, 2:] if labels.shape[1] > 2 else labels[:, :0]
        if mtp_labels.shape[1] > 0:
            h_mtp = _mtp_hidden(params, h, inputs, cfg, use_kernel=use_kernel)
            loss = loss + cfg.mtp_loss_weight * head_xent(
                w, h_mtp[:, :mtp_labels.shape[1]], mtp_labels, cfg,
                sample_weights)
    return loss
