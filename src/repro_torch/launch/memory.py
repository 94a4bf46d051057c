"""Device-memory reckonings from a model's shapes, in bytes: the one copy
of what ``chip_smoke.py`` prints beside a run's measured peak (phases 17,
18, 19 and 20) and what the dry-run adds to a record's
``memory_analysis`` where one was built for the arch and the step's kind
(``launch.dryrun.RECKONINGS``).  Each returns its terms and their
``peak``.
"""
from __future__ import annotations

import math

from repro_torch.models import encdec
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.models.param import ParamDef, _map_defs


def def_bytes(defs) -> int:
    """Bytes of a nested def tree (dicts and lists of ``ParamDef``)."""
    if isinstance(defs, ParamDef):
        return defs.size * defs.dtype.itemsize
    vals = defs.values() if isinstance(defs, dict) else defs
    return sum(def_bytes(v) for v in vals)


def mixtral_reckoning(cfg, batch: int, prompt_len: int,
                      decode_tokens: int) -> dict:
    """A serve run's device memory reckoned from its shapes, in bytes: the
    weights; the init's float32 draw of the largest leaf (an expert
    weight ``wi``); the prefill's transients, the experts' products
    ([B, E, cap, 2, F] and the gated [B, E, cap, F] twice, the dispatched
    rows and the experts' outputs [B, E, cap, D]) and the logits (in the
    compute dtype, then f32); the KV caches (ring caches of the window's
    slots)."""
    es = cfg.compute_dtype.itemsize
    e, f, d = cfg.moe_num_experts, cfg.expert_d_ff, cfg.d_model
    slots = batch * e * moe.expert_capacity(cfg, prompt_len)
    cache_len = prompt_len + decode_tokens
    if cfg.window:
        cache_len = min(cache_len, cfg.window)
    r = {"weights": def_bytes(tfm.model_defs(cfg)),
         "init_f32_leaf": 4 * e * d * 2 * f,
         "experts": es * slots * (4 * f + 2 * d),
         "logits": batch * prompt_len * cfg.padded_vocab * (4 + es),
         "caches": cfg.n_layers * 2 * batch * cache_len * cfg.n_kv_heads
         * cfg.resolved_head_dim * es}
    r["peak"] = r["weights"] + max(
        r["init_f32_leaf"], r["experts"] + r["logits"] + r["caches"])
    return r


def deepseek_reckoning(cfg, batch: int, prompt_len: int,
                       decode_tokens: int) -> dict:
    """``mixtral_reckoning``'s terms for an MLA + MoE model, with the
    caches its latents ([B, L, kv_lora_rank + rope] a layer), and the
    prefill's MLA transients (the expanded q and k [B, S, H, nope + rope],
    k_nope and v [B, S, H, v]) and the combine's [B, S, K, D] twice beside
    the experts' and the logits."""
    r = mixtral_reckoning(cfg, batch, prompt_len, decode_tokens)
    es = cfg.compute_dtype.itemsize
    tokens = batch * prompt_len
    r["caches"] = (cfg.n_layers * batch * (prompt_len + decode_tokens)
                   * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * es)
    r["attention"] = es * tokens * cfg.n_heads * 2 * (
        cfg.qk_nope_head_dim + cfg.qk_rope_head_dim + cfg.v_head_dim)
    r["combine"] = 2 * es * tokens * cfg.moe_top_k * cfg.d_model
    r["peak"] = r["weights"] + max(
        r["init_f32_leaf"], r["experts"] + r["combine"] + r["attention"]
        + r["logits"] + r["caches"])
    return r


def train_reckoning(cfg, clients: int, seq: int) -> dict:
    """A ``launch.train`` step's device memory reckoned from its shapes, in
    bytes, at ``clients`` x 1 x ``seq`` tokens: the weights; the step's f32
    noise draws (one z per leaf); the gradients and their noisy copy;
    what the forward keeps for the backward, by layer kind (an attention
    layer's q, k, v, f32 output and row statistics, and one key block's
    scores, p and their gradients while it runs; an RG-LRU layer's f32
    gates and the doubling scan's two f32 levels a step, log2 S steps;
    the FFN's four [T, F] products; the residual stream's f32 norms, two
    a sublayer); the loss head's one chunk of f32 logits five times over
    (the softcap, the log-sum-exp and their gradients).  An
    encoder-decoder (``clients`` x ``seq`` frames and tokens) counts the
    encoder's self-attentions and the decoder's self- and
    cross-attentions (a third sublayer a decoder layer), and the
    encoder's output, which every cross-attention's backward reads.  The
    peak is the largest of the forward's end (weights, noise,
    activations, the head and the unembedding's gradient) and the step's
    end (weights, noise, two gradient trees and the SGD update's f32
    copies of the largest leaf)."""
    es = cfg.compute_dtype.itemsize
    defs = encdec.encdec_defs(cfg) if cfg.is_enc_dec else tfm.model_defs(cfg)
    weights = def_bytes(defs)
    sizes = []
    _map_defs(defs, lambda d: sizes.append(d.size))
    n_params = sum(sizes)
    d, dh, h, kh = (cfg.d_model, cfg.resolved_head_dim, cfg.n_heads,
                    cfg.n_kv_heads)
    tokens = clients * seq
    if cfg.is_enc_dec:
        n_layers = cfg.encoder_layers + cfg.n_layers
        n_attn, n_rglru = cfg.encoder_layers + 2 * cfg.n_layers, 0
        sublayers = 2 * cfg.encoder_layers + 3 * cfg.n_layers
        memory = tokens * d * es
    else:
        kinds = [kind for kind, _ in tfm.layer_sigs(cfg)]
        n_layers, n_attn = len(kinds), sum(k != "rglru" for k in kinds)
        n_rglru, sublayers, memory = n_layers - n_attn, 2 * n_layers, 0
    w = cfg.lru_width or d
    attn = tokens * (h * dh * es + 2 * kh * dh * es + h * dh * 4 + h * 8)
    block = 5 * 4 * tokens * h * 1024
    rglru = 4 * tokens * w * (6 + 2 * math.ceil(math.log2(seq)))
    ffn = 4 * tokens * cfg.d_ff * es
    resid = 2 * tokens * d * 4
    r = {"weights": weights, "noise": 4 * n_params,
         "activations": n_attn * attn + n_rglru * rglru + n_layers * ffn
         + sublayers * resid + memory + (block if n_attn else 0),
         "head": 5 * 4 * tfm.HEAD_CHUNK * cfg.padded_vocab,
         "unembed_grad": cfg.padded_vocab * d * es,
         "grads": 2 * weights, "sgd_f32": 3 * 4 * max(sizes)}
    r["peak"] = r["weights"] + r["noise"] + max(
        r["activations"] + r["head"] + r["unembed_grad"],
        r["grads"] + r["sgd_f32"])
    return r
