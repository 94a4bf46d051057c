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
K3 and K4 have no backward.
"""
from __future__ import annotations

from typing import Optional

import torch

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
# Sq * Sk past which the reference's ``grouped_attention`` takes its blocked
# online-softmax scan (``repro/models/attention.py:80``); the port has not
# ported that form, so the plain train forward refuses such lengths
BLOCKED_ATTENTION = 2048 * 2048


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
    x = embed(params["embed"], tokens, cfg.compute_dtype) \
        if cfg.input_mode == "tokens" else tokens.to(cfg.compute_dtype)
    aux = 0.0
    for i, sig in enumerate(layer_sigs(cfg)):
        x, _, layer_aux = apply_layer(
            params["layers"][i], x, cfg, sig, pos_offset=pos_offset,
            cache=None if caches is None else caches[i], decode=decode,
            use_kernel=use_kernel)
        aux = aux + layer_aux
    h = rmsnorm(params["ln_f"], x, cfg.norm_eps)
    logits = unembed(_unembedding(params, cfg), h, cfg)
    return (logits, caches, aux, h) if return_hidden \
        else (logits, caches, aux)


def _unembedding(params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


def mtp_logits(params, h: torch.Tensor, tokens: torch.Tensor,
               cfg: ModelConfig, use_kernel: bool = True) -> torch.Tensor:
    """The reference's DeepSeek-V3 MTP head: position i from (h_i,
    emb(tokens[i + 1])).  h: [B, S, D] the final normed hidden state;
    tokens: [B, S].  Returns logits [B, S - 1, V] in float32.  Which label
    position i is trained on is ``lm_loss``'s choice: the reference's
    ``tokens[i + 3]`` of the input."""
    p = params["mtp"]
    ct = cfg.compute_dtype
    emb_next = embed(params["embed"], tokens[:, 1:], ct)
    h_in = rmsnorm(p["ln_in"], h[:, :-1], cfg.norm_eps)
    fused = torch.cat([h_in, emb_next], dim=-1)
    x = fused.to(ct) @ p["proj"].to(ct)
    x, _, _ = apply_layer(p["layer"], x, cfg, ("attn", "dense"),
                          use_kernel=use_kernel)
    h_out = rmsnorm(p["ln_out"], x, cfg.norm_eps)
    return unembed(_unembedding(params, cfg), h_out, cfg)


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
    mask = (labels >= 0).float()
    labels_safe = torch.clamp(labels, min=0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels_safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    if sample_weights is not None:
        w = sample_weights.float()
        per_sample = torch.sum(nll, dim=-1) / torch.clamp(
            torch.sum(mask, dim=-1), min=1)
        return torch.mean(w * per_sample)
    return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1)


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
    s = inputs.shape[1]
    kinds = {kind for kind, _ in layer_sigs(cfg)}
    if not use_kernel and kinds & set(GQA_KINDS) \
            and s * s > BLOCKED_ATTENTION:
        raise NotImplementedError(
            f"a train sequence of {s} tokens: the reference attends to it "
            "with its blocked online-softmax scan (Sq * Sk > 2048^2), which "
            "is not ported to repro_torch yet (see ROADMAP.md, modules to "
            "port)")
    logits, _, aux, h = forward_aux(params, inputs, cfg,
                                    use_kernel=use_kernel,
                                    return_hidden=True)
    loss = softmax_xent(logits, labels, cfg.padded_vocab, sample_weights)
    if cfg.moe_num_experts:
        loss = loss + cfg.router_aux_weight * aux
    if cfg.mtp_depth:
        mtp_labels = labels[:, 2:] if labels.shape[1] > 2 else labels[:, :0]
        if mtp_labels.shape[1] > 0:
            mtp_lg = mtp_logits(params, h, inputs, cfg,
                                use_kernel=use_kernel)
            loss = loss + cfg.mtp_loss_weight * softmax_xent(
                mtp_lg[:, :mtp_labels.shape[1]], mtp_labels,
                cfg.padded_vocab, sample_weights)
    return loss
