"""The language models on a mesh of ranks (modules 12b and 12c): the dense
GQA decoders, Mamba-2, RecurrentGemma, the encoder-decoder and MoE, with
parameters, caches and activations as DTensors laid out by the
reference's specs and logical-axis rules.

``models.transformer`` and ``models.encdec`` hand a forward, a loss, an
encoder pass, the cross caches or a decode step here when their
parameters are DTensors and a mesh is bound (``distributed.mesh_rules``);
one card never comes here.  The layout is the reference's:

* parameters as ``launch.steps.shard_params`` lays them out, by their
  ``ParamDef.spec``: column-parallel weights' out-dim over "model" and
  in-dim over "data" (FSDP), row-parallel ones the transpose;
* activations [B, S, D] with the batch over the batch axes ("data", or
  ("pod", "data")), when it divides them, and replicated over "model"
  (``distributed.constrain`` after the embedding, or on the encoder's
  frames, and after each layer, as ``repro/models/transformer.py:212``,
  ``:279`` and ``repro/models/encdec.py:56``, ``:68``).

Each sublayer is one ``distributed.shard_map`` (DTensor's ``local_map``)
of the plain model code on each rank's local tensors, with its placements
chosen here rather than left to DTensor's choice per op: a layer first
gathers its weights over "data" (and, where it needs them whole, over
"model") to the placements it computes with -- the explicit FSDP gather
-- and the activations keep their batch shard.  A sublayer that splits
its work over "model" returns a partial sum, which one all-reduce over
"model" completes (or a query-sequence block, which one all-gather does);
its replicated inputs' gradients are partial sums over the axes it splits
its work over, which DTensor reduces on the way back: over the batch
axes, that reduction of the weighted loss's gradient is the OTA
superposition sum_m s_m g_m of the train step (``launch.steps``).

Attention (``attention``): with H % tp == 0, each "model" rank takes
H / tp query heads and the KV heads they read (the KV heads' own shards
when KH % tp == 0; else all KH heads, and a selection per rank); with
H % tp != 0 (qwen2.5-14b's 40 heads at TP 16) a prefill splits the query
SEQUENCE over "model" (``repro/models/attention.py:225-233``): rank r
projects its block of S / tp query rows against all S keys, and K3 takes
the block's offset (``q_offset``); a decode step, or a sequence that tp
does not divide, is computed whole on every "model" rank.  K3 and K4 run
on each rank's local tensors (``distributed.per_rank`` under
``LocalTensorMode``: one launch per rank and layer).  The
encoder-decoder's cross-attention (``_cross``) takes the same heads: q
of the rank's heads from x, K and V of their KV heads from the encoder's
memory or from the cross cache (laid out as a KV cache), ``wo``
row-parallel; a prefill through K3 non-causal, a decode step through the
plain attention, as ``attention.cross_apply``.

Mamba-2 (``ssd``): ``in_proj``'s out-dim [z, xBC, dt] is sharded over
"model" as one axis (the reference's spec), and its parts do not fall on
the shard boundaries; so it is gathered whole, and each rank projects
onto the columns of its nheads / tp heads (z, x, dt) and the shared B and
C (ngroups 1); the conv, the scan (K4) and the gate run on those heads;
the gated norm's sum of squares over d_inner is one all-reduce, and
``out_proj`` is row-parallel (its rows are the heads').  The conv window
cache is sharded over channels that do not fall on heads either: it is
gathered before the mixer and written back after it.

The RG-LRU (``_rglru``): ``w_branch`` and ``w_gate`` column-parallel,
each rank W / tp channels; the conv on the rank's channels; the gates
read all of the conv's output z (``w_a`` and ``w_x`` are [W, W],
replicated), so z is all-gathered over "model" once and rank r takes
their columns of its channels; the scan, the decode update and the
states (``h``, ``conv``: the reference's cache specs, the channels over
"model") stay on the rank's channels; ``w_out`` row-parallel.

MoE (``_moe``): the router (replicated, f32) routes each rank's batch
rows; the dispatch and the combine stay local to the batch shard (the
reference's ``shard_map``, ``repro/models/moe.py:118-145``: the capacity
is per row, so a shard's dispatch is exact); the experts' weights are
gathered over "data" (E or D, whichever the spec puts there) to all
experts and the rank's F columns, and ``wo``'s F rows give a partial sum
over "model".  The load-balance loss is global: each rank's counts of
first choices and sums of probabilities are reduced over the batch axes
before the product.

Any cache whose layout the step cannot compute on (a KV cache sharded
over its sequence, the long-context rule "kv_seq" over "data") is
gathered to the layout it needs first and written back after.

Refused by name (``check_sharded``): MLA and the MTP head
(deepseek-v3-671b; ROADMAP.md §1, 12c.4).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import distributed as dist
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_rope, dense, embed, mlp,
                                       rmsnorm, unembed)
from repro_torch.models.param import P

Layout = dist.Layout


MESH_MIXERS = ("attn", "swa", "local", "ssd", "rglru")
ENC_SIG = ("enc_attn", "dense")         # ``models.encdec``'s block kinds
DEC_SIG = ("attn", "dense")


def check_sharded(cfg: ModelConfig) -> None:
    """Raise for what does not run on a mesh yet: MLA and the MTP head
    (ROADMAP.md §1, 12c.4)."""
    missing = []
    if cfg.attn_kind != "gqa":
        missing.append("MLA" if cfg.attn_kind == "mla"
                       else f"{cfg.attn_kind} attention")
    if cfg.mtp_depth:
        missing.append("MTP")
    if cfg.input_mode != "tokens" and not (
            cfg.input_mode == "frames" and cfg.is_enc_dec):
        missing.append(f"{cfg.input_mode} inputs")
    missing += [f"{k} mixer" for k in sorted(set(cfg.block_pattern))
                if k not in MESH_MIXERS]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not sharded over a mesh yet "
            "(ROADMAP.md §1, 12c.4)")


def on_mesh(params) -> bool:
    """Whether ``params`` are DTensors and a mesh is bound."""
    if dist.active_mesh() is None:
        return False
    leaf = params
    while not isinstance(leaf, torch.Tensor):
        leaf = next(iter(leaf.values())) if hasattr(leaf, "values") \
            else leaf[0] if isinstance(leaf, (list, tuple)) \
            else next(iter(leaf.parameters()))
    return dist.is_dtensor(leaf)


class _Ctx:
    """The bound mesh and one step's batch layout."""

    def __init__(self, batch: int):
        self.mesh = dist.active_mesh()
        self.tp = self.mesh.shape.get("model", 1)
        baxes = mesh_lib.batch_axes(self.mesh)
        n = 1
        for a in baxes:
            n *= self.mesh.shape[a]
        self.bdiv = batch % n == 0
        self.baxes = baxes if self.bdiv else ()
        self.b = baxes if self.bdiv else None       # the batch dim's axes
        self.r = self.mesh.local_rank("model") if "model" in \
            self.mesh.axis_names else 0

    def act(self, ndim: int = 3) -> P:
        """[B, ...] activations: batch over the batch axes."""
        return P(self.b, *([None] * (ndim - 1)))

    def grad(self, spec: P, split_model: bool) -> Layout:
        """The gradient layout of an input laid out as ``spec`` to a body
        that splits its work over the batch axes and, with
        ``split_model``, over "model": partial over those it is replicated
        on."""
        named = {a for ax in spec if ax is not None
                 for a in ((ax,) if isinstance(ax, str) else ax)}
        part = [a for a in self.baxes if a not in named]
        if split_model and "model" not in named and "model" in \
                self.mesh.axis_names:
            part.append("model")
        return Layout(spec, tuple(part))

    def to(self, x, spec: P, partial=()):
        """``x`` redistributed to ``spec``'s layout (``x`` itself when it
        has it): for a weight, the explicit gather over "data" (and over
        "model" where ``spec`` has no "model")."""
        want = dist.placements(self.mesh, spec, partial)
        if tuple(x.placements) == want:
            return x
        return x.redistribute(self.mesh.device_mesh, want)

    def run(self, fn, args: tuple, in_specs: tuple, out_specs,
            split_model: bool, no_grad: tuple = ()):
        """``fn(r, *locals)`` on this rank's "model" coordinate r and the
        local tensors of ``args`` (pytrees of DTensors, each already laid
        out as its spec in ``in_specs``, a matching pytree of specs); the
        gradient layouts from ``grad`` (``no_grad``: argument indices that
        carry no gradient, such as token ids and caches).  Whatever
        depends on the rank is computed in ``fn`` from r."""
        grads = tuple(
            _tree_map(lambda sp: Layout(sp), spec) if i in no_grad
            else _tree_map(lambda sp: self.grad(sp, split_model), spec)
            for i, spec in enumerate(in_specs))
        flat_in = tuple(_leaves(s) for s in in_specs)
        flat_grad = tuple(_leaves(s) for s in grads)
        # serving: the body once per simulated rank on its plain tensors
        # and its int r (op by op, LocalTensorMode takes each op's ranks in
        # Python); autograd needs the op-by-op form
        body = fn if torch.is_grad_enabled() else dist.per_rank(fn)
        r = self.r
        return dist.shard_map(
            lambda *a: body(r, *a), self.mesh,
            [e for f in flat_in for e in f], out_specs,
            [e for f in flat_grad for e in f])(*args)


def _tree_map(fn, tree):
    if isinstance(tree, (P, Layout)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return type(tree)(_tree_map(fn, v) for v in tree)


def _leaves(tree) -> list:
    if isinstance(tree, (P, Layout)):
        return [tree]
    vals = tree.values() if isinstance(tree, dict) else tree
    return [leaf for v in vals for leaf in _leaves(v)]


def _params(p) -> dict:
    """A ParamTree (or a trainable view of one) as nested dicts of its
    tensors, in the ParamTree's order."""
    if isinstance(p, torch.Tensor):
        return p
    if isinstance(p, torch.nn.Module):
        items = list(p._parameters.items()) + list(p._modules.items())
        return {k: _params(v) for k, v in items}
    return {k: _params(v) for k, v in p.items()}


def _arange(n: int, start, device) -> torch.Tensor:
    """start + [0, n): ``start`` may be one int per simulated rank."""
    return torch.arange(n, device=device) + start


# ---------------------------------------------------------------------------
# Embedding, norms, unembedding
# ---------------------------------------------------------------------------

def _embed(ctx: _Ctx, table, ids, cfg: ModelConfig):
    """The token embedding: with the vocab over "model", each rank looks
    up the ids in its rows (zeros for the others) and one all-reduce over
    "model" sums them."""
    v = table.shape[0]
    act, ids_spec = ctx.act(3), ctx.act(2)
    if v % ctx.tp:
        spec = P(None, None)
        out = ctx.run(lambda r, t, i: embed(t, i, cfg.compute_dtype),
                      (ctx.to(table, spec), ids), (spec, ids_spec), act,
                      split_model=False, no_grad=(1,))
        return out
    spec = P("model", None)

    def body(r, t, i):
        rows = t.shape[0]
        local = i - r * rows
        keep = (local >= 0) & (local < rows)
        out = embed(t, torch.clamp(local, 0, rows - 1), cfg.compute_dtype)
        return out * keep[..., None].to(out.dtype)

    out = ctx.run(body, (ctx.to(table, spec), ids), (spec, ids_spec),
                  Layout(act, ("model",)), split_model=True, no_grad=(1,))
    return ctx.to(out, act)


def _rmsnorm(ctx: _Ctx, w, x, eps: float):
    return ctx.run(lambda r, w_, x_: rmsnorm(w_, x_, eps),
                   (ctx.to(w, P(None)), x), (P(None), ctx.act()),
                   ctx.act(), split_model=False)


def _unembedding(ctx: _Ctx, params, cfg: ModelConfig):
    """(weight, transposed, its compute spec): the unembedding [D, V], or
    the tied embedding [V, D] read transposed; the vocab over "model"
    where tp divides it."""
    tied = cfg.tie_embeddings
    w = params["embed"] if tied else params["unembed"]
    vdim = 0 if tied else 1
    split = w.shape[vdim] % ctx.tp == 0
    spec = P(*[("model" if split and i == vdim else None) for i in range(2)])
    return ctx.to(w, spec), tied, spec, split


def _logits(ctx: _Ctx, params, h, cfg: ModelConfig):
    """(logits [B, S, V] in float32, whether the vocab is over "model":
    where tp divides it)."""
    w, tied, spec, split = _unembedding(ctx, params, cfg)
    out = P(ctx.b, None, "model" if split else None)
    return ctx.run(lambda r, w_, h_: unembed(w_.T if tied else w_, h_, cfg),
                   (w, h), (spec, ctx.act()), out, split_model=split), split


def _xent(ctx: _Ctx, logits, split: bool, labels, sample_weights):
    """``transformer.softmax_xent`` of vocab-sharded logits: the row max
    and the log-sum-exp over the vocab shards, and the gold logit from
    the rank that holds it, each completed over "model" by one
    collective; then the (weighted) mean over the global batch."""
    b, s = labels.shape
    act2 = ctx.act(2)
    lspec = P(ctx.b, None, "model" if split else None)

    # the row max, for the exponent's range only: no gradient
    with torch.no_grad():
        m = ctx.run(lambda r, lg: lg.amax(-1, keepdim=True),
                    (logits.detach(),), (lspec,), lspec, split_model=False,
                    no_grad=(0,))
        m = ctx.to(m, ctx.act()).amax(-1) if split else m[..., 0]

    def body(r, lg, m_, lab):
        rows = lg.shape[-1]
        se = torch.exp(lg - m_[..., None]).sum(-1)
        local = torch.clamp(lab, min=0).long() - (r * rows if split else 0)
        keep = (local >= 0) & (local < rows)
        gold = torch.gather(lg, -1, torch.clamp(local, 0, rows - 1)[..., None]
                            )[..., 0] * keep.float()
        return se, gold

    part = ("model",) if split else ()
    se, gold = ctx.run(body, (logits, m, labels), (lspec, act2, act2),
                       (Layout(act2, part), Layout(act2, part)),
                       split_model=split, no_grad=(1, 2))
    se, gold = ctx.to(se, act2), ctx.to(gold, act2)

    def mean(r, se_, gold_, m_, lab, *w):
        mask = (lab >= 0).float()
        nll = (torch.log(se_) + m_ - gold_) * mask
        if w:
            per = torch.sum(nll, -1) / torch.clamp(torch.sum(mask, -1), min=1)
            return torch.sum(w[0].float() * per)[None] / b, mask.sum()[None]
        return torch.sum(nll)[None], mask.sum()[None]

    one = P(None)
    args = (se, gold, m, labels) + (() if sample_weights is None
                                    else (sample_weights,))
    specs = (act2,) * 4 + (() if sample_weights is None else (ctx.act(1),))
    total, count = ctx.run(mean, args, specs,
                           (Layout(one, ctx.baxes), Layout(one, ctx.baxes)),
                           split_model=False, no_grad=(2, 3))
    total, count = ctx.to(total, one), ctx.to(count, one)
    if sample_weights is not None:
        return total[0]
    return total[0] / torch.clamp(count[0], min=1)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _attn_mode(ctx: _Ctx, cfg: ModelConfig, s: int, decode: bool) -> str:
    if cfg.n_heads % ctx.tp == 0:
        return "heads"
    if not decode and s > 1 and s % ctx.tp == 0:
        return "seq"
    return "whole"


def _moved(ctx: _Ctx, tree: Optional[dict], specs: dict):
    """(``tree``'s leaves laid out as ``specs`` says (by key), a
    write-back): a cache leaf in another layout is redistributed (a copy)
    and written back into its own shards after the step."""
    if tree is None:
        return None, lambda: None
    moved = {k: ctx.to(v, specs[k]) for k, v in tree.items()}

    def back():
        for k, v in tree.items():
            if moved[k] is not v:
                v.to_local().copy_(ctx.to(moved[k], _spec_of(ctx, v))
                                   .to_local())
    return moved, back


def _spec_of(ctx: _Ctx, t) -> P:
    """The spec of a DTensor with no partial placement."""
    from torch.distributed.tensor import Shard
    dims = [None] * t.dim()
    for name, pl in zip(ctx.mesh.axis_names, t.placements):
        if isinstance(pl, Shard):
            d = dims[pl.dim]
            dims[pl.dim] = name if d is None else (
                (d,) if isinstance(d, str) else d) + (name,)
    return P(*dims)


def _kv_select(heads: bool, kv_split: bool, h: int, kh: int, hl: int, r,
               device):
    """Rank r's q heads' KV heads out of all KH, as a function of a
    [B, S, KH, Dh] tensor (by index: one KV head when the rank's hl heads
    share it, else one per q head); None where the rank holds its own KV
    heads or all q heads (``heads`` False)."""
    g = h // kh
    if not heads or kv_split:
        return None
    if g % hl == 0:
        idx = _arange(1, (r * hl) // g, device)
    else:
        idx = (_arange(hl, r * hl, device)) // g
    return lambda t: torch.index_select(t, 2, idx)


def _attention(ctx: _Ctx, p, x, cfg: ModelConfig, *, kind: str,
               pos_offset: int, cache: Optional[dict], decode: bool,
               use_kernel: bool):
    """``attention.gqa_apply`` on the mesh; (out, cache)."""
    b, s, _ = x.shape
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    tp, act = ctx.tp, ctx.act()
    mode = _attn_mode(ctx, cfg, s, decode)
    kv_split = mode == "heads" and kh % tp == 0
    col = "model" if mode == "heads" else None
    kv_col = "model" if kv_split else None
    specs = {"wq": {"w": P(None, col), **({"b": P(col)} if "b" in p["wq"]
                                          else {})},
             "wkv": P(None, None, kv_col),
             "wo": {"w": P(col, None)}}
    if "bkv" in p:
        specs["bkv"] = P(None, kv_col)
    for key in ("q_norm", "k_norm"):
        if key in p:
            specs[key] = P(None)
    pp = _tree_map_pair(ctx.to, _params(p), specs)
    cspec = P(ctx.b, None, kv_col, None)
    cspecs = {k: cspec for k in cache} if cache is not None else None
    cache_l, write_back = _moved(ctx, cache, cspecs)
    hl, kvl = (h // tp, kh // tp if kv_split else kh) if mode == "heads" \
        else (h, kh)

    def body(r, pl, xl, *cl):
        c = dict(zip(cache, cl)) if cache is not None else None
        if mode == "seq":
            sl = s // tp
            rows = _arange(sl, r * sl, xl.device)
            q = attn_mod.gqa_q(pl, torch.index_select(xl, 1, rows), cfg, h)
            qpos = pos_offset + rows
            q_offset = r * sl
        else:
            q = attn_mod.gqa_q(pl, xl, cfg, hl)
            qpos = pos_offset + torch.arange(s, device=xl.device)
            q_offset = 0
        k, v = attn_mod.gqa_kv(pl, xl, cfg, kvl)
        kpos = pos_offset + torch.arange(s, device=xl.device)
        q = apply_rope(q, qpos, cfg.rope_theta)
        k = apply_rope(k, kpos, cfg.rope_theta)
        out = attn_mod.gqa_attend(q, k, v, cfg, kind=kind,
                                  pos_offset=pos_offset, cache=c,
                                  decode=decode, use_kernel=use_kernel,
                                  select=_kv_select(mode == "heads", kv_split,
                                                    h, kh, hl, r, xl.device),
                                  q_offset=q_offset)
        out = out.reshape(out.shape[0], out.shape[1], -1)
        return dense(pl["wo"], out, cfg.compute_dtype)

    if mode == "heads":
        out_spec = Layout(act, ("model",))
    elif mode == "seq":
        out_spec = P(ctx.b, "model", None)
    else:
        out_spec = act
    args = (pp, x) + tuple(cache_l.values() if cache_l else ())
    in_specs = (specs, act) + tuple(cspecs.values() if cspecs else ())
    nc = tuple(range(2, len(args)))
    out = ctx.run(body, args, in_specs, out_spec,
                  split_model=mode != "whole", no_grad=nc)
    write_back()
    return ctx.to(out, act), cache


def _tree_map_pair(fn, tree, specs):
    if isinstance(specs, (P, Layout)):
        return fn(tree, specs)
    return {k: _tree_map_pair(fn, tree[k], specs[k]) for k in specs}


def _cross(ctx: _Ctx, p, x, memory, cfg: ModelConfig, *,
           cache: Optional[dict], decode: bool, use_kernel: bool):
    """``attention.cross_apply`` on the mesh: q of the rank's heads from
    x, K and V of their KV heads from ``memory`` (``wk`` / ``wv``) or from
    ``cache`` (read only), the attention (K3 non-causal in a prefill, the
    plain attention in a decode step), ``wo`` row-parallel: a partial sum
    over "model", one all-reduce.  Where tp does not divide H, whole on
    every "model" rank."""
    h, kh, act = cfg.n_heads, cfg.n_kv_heads, ctx.act()
    split = h % ctx.tp == 0
    kv_split = split and kh % ctx.tp == 0
    col = "model" if split else None
    kv_col = "model" if kv_split else None
    specs = {"wq": {"w": P(None, col)}, "wo": {"w": P(col, None)}}
    if cache is None:
        specs.update(wk={"w": P(None, kv_col)}, wv={"w": P(None, kv_col)})
    pp = _tree_map_pair(ctx.to, _params(p), specs)
    hl = h // ctx.tp if split else h
    kvl = kh // ctx.tp if kv_split else kh
    cspec = P(ctx.b, None, kv_col, None)
    if cache is None:
        src, src_specs = (memory,), (act,)
    else:
        moved, _ = _moved(ctx, cache, {"k": cspec, "v": cspec})
        src, src_specs = (moved["k"], moved["v"]), (cspec, cspec)

    def body(r, pl, xl, *srcl):
        cache_l = None if cache is None else dict(zip(("k", "v"), srcl))
        return attn_mod.cross_apply(
            pl, xl, srcl[0] if cache is None else None, cfg, cache=cache_l,
            decode=decode, use_kernel=use_kernel, heads=(hl, kvl),
            select=_kv_select(split, kv_split, h, kh, hl, r, xl.device))

    out = ctx.run(body, (pp, x) + src, (specs, act) + src_specs,
                  Layout(act, ("model",)) if split else act,
                  split_model=split,
                  no_grad=() if cache is None else (2, 3))
    return ctx.to(out, act)


def _cross_cache(ctx: _Ctx, p, memory, cfg: ModelConfig) -> dict:
    """``attention.cross_cache`` on the mesh: each rank's K and V of its
    KV heads (where tp divides KH) over its batch rows, laid out as the
    reference lays out a KV cache (``launch.steps._cache_leaf_spec``)."""
    from repro_torch.launch.steps import _cache_leaf_spec
    kh = cfg.n_kv_heads
    kv_col = "model" if kh % ctx.tp == 0 else None
    specs = {"wk": {"w": P(None, kv_col)}, "wv": {"w": P(None, kv_col)}}
    pp = _tree_map_pair(ctx.to, _params(p), specs)
    kvl = kh // ctx.tp if kv_col else kh

    def body(r, pl, m):
        kv = attn_mod.cross_cache(pl, m, cfg, kvl)
        return kv["k"], kv["v"]

    spec = P(ctx.b, None, kv_col, None)
    k, v = ctx.run(body, (pp, memory), (specs, ctx.act()), (spec, spec),
                   split_model=kv_col is not None)
    want = _cache_leaf_spec("k", tuple(k.shape), ctx.mesh, ctx.bdiv)
    return {"k": ctx.to(k, want), "v": ctx.to(v, want)}


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def _mlp(ctx: _Ctx, p, x, cfg: ModelConfig):
    """The dense MLP (or MoE's shared experts): its width over "model" (a
    partial sum, one all-reduce), or whole where tp does not divide it."""
    gated = cfg.ffn_kind in ("swiglu", "geglu")
    split = p["wo"]["w"].shape[0] % ctx.tp == 0
    col = "model" if split else None
    specs = {"wi": {"w": P(None, None, col) if gated else P(None, col)},
             "wo": {"w": P(col, None)}}
    if "b" in p["wi"]:
        specs["wi"]["b"] = P(col)
    pp = _tree_map_pair(ctx.to, _params(p), specs)
    act = ctx.act()
    out = ctx.run(lambda r, pl, xl: mlp(pl, xl, cfg), (pp, x), (specs, act),
                  Layout(act, ("model",)) if split else act,
                  split_model=split)
    return ctx.to(out, act)


# ---------------------------------------------------------------------------
# Mamba-2
# ---------------------------------------------------------------------------

def _ssd(ctx: _Ctx, p, x, cfg: ModelConfig, *, state: Optional[dict],
         decode: bool, use_kernel: bool):
    """``ssm.ssd_apply`` on the mesh; (out, state)."""
    d_inner, nheads, conv_dim = ssm_mod._dims(cfg)
    g, n, hd = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_headdim
    tp, act = ctx.tp, ctx.act()
    full = {k: P(*([None] * v.dim())) for k, v in _params(p).items()}
    if nheads % tp or g != 1:
        # whole on every "model" rank
        pp = _tree_map_pair(ctx.to, _params(p), full)
        sspec = {"ssm": P(ctx.b, None, None, None),
                 "conv": P(ctx.b, None, None)}
        st, write_back = _moved(ctx, state, sspec)

        def whole(r, pl, xl, *sl):
            s_ = dict(zip(("ssm", "conv"), sl)) if sl else None
            return ssm_mod.ssd_apply(pl, xl, cfg, state=s_, decode=decode,
                                     use_kernel=use_kernel)[0]
        args = (pp, x) + ((st["ssm"], st["conv"]) if st else ())
        specs = (full, act) + ((sspec["ssm"], sspec["conv"]) if st else ())
        out = ctx.run(whole, args, specs, act, split_model=False,
                      no_grad=tuple(range(2, len(args))))
        write_back()
        return out, state

    hl = nheads // tp
    dl = hl * hd

    pp = _tree_map_pair(ctx.to, _params(p), full)
    sspec = {"ssm": P(ctx.b, "model", None, None),
             "conv": P(ctx.b, None, None)}
    st, write_back = _moved(ctx, state, sspec)
    k = cfg.ssm_conv - 1

    def body(r, pl, xl, *sl):
        # rank r's columns of in_proj [z | x | B | C | dt] and of the conv's
        # channels [x | B | C]; ngroups 1: B and C are every head's
        dev = xl.device
        z_cols = _arange(dl, r * dl, dev)
        bc = torch.arange(2 * n, device=dev)
        cols = torch.cat([z_cols, z_cols + d_inner, bc + 2 * d_inner,
                          _arange(hl, r * hl, dev) + 2 * d_inner + 2 * n])
        ch = torch.cat([z_cols, bc + d_inner])
        heads = _arange(hl, r * hl, dev)
        ct = cfg.compute_dtype
        w = torch.index_select(pl["in_proj"], 1, cols)
        zxbcdt = xl.to(ct) @ w.to(ct)
        z, xbc, dt = torch.split(zxbcdt, [dl, dl + 2 * n, hl], -1)
        local = {"conv_w": torch.index_select(pl["conv_w"], 1, ch),
                 "conv_b": torch.index_select(pl["conv_b"], 0, ch),
                 **{key: torch.index_select(pl[key], 0, heads)
                    for key in ("a_log", "dt_bias", "d_skip")}}
        s_ = None
        if sl:
            s_ = {"ssm": sl[0],
                  "conv": torch.index_select(sl[1], 2, ch).contiguous()}
        y = ssm_mod.ssd_gated(local, z, xbc, dt, cfg, hl, 1, state=s_,
                              decode=decode, use_kernel=use_kernel)
        ss = torch.sum(y.float() * y.float(), -1, keepdim=True)
        if s_ is None:
            return y, ss
        return y, ss, s_["conv"][..., :dl], s_["conv"][..., dl:]

    args = (pp, x) + ((st["ssm"], st["conv"]) if st else ())
    specs = (full, act) + ((sspec["ssm"], sspec["conv"]) if st else ())
    outs = (P(ctx.b, None, "model"), Layout(act, ("model",)))
    if st:
        outs += (P(ctx.b, None, "model"), P(ctx.b, None, None))
    res = ctx.run(body, args, specs, outs, split_model=True,
                  no_grad=tuple(range(2, len(args))))
    y, ss = res[0], ctx.to(res[1], act)
    if st:
        # the new conv window: the x channels from every rank, B and C
        xwin = ctx.to(res[2], P(ctx.b, None, None))
        st["conv"].to_local().copy_(torch.cat(
            [xwin.to_local(), res[3].to_local()], -1).to(
            st["conv"].dtype))
        write_back()

    nspec, ospec = P("model"), P("model", None)

    def norm_out(r, yl, ssl, wn, wo):
        ct = cfg.compute_dtype
        yf = yl.float()
        yn = (yf * torch.rsqrt(ssl / d_inner + cfg.norm_eps)
              * wn.float()).to(yl.dtype)
        return yn.to(ct) @ wo.to(ct)

    out = ctx.run(norm_out, (y, ss, ctx.to(p["norm"], nspec),
                             ctx.to(p["out_proj"], ospec)),
                  (P(ctx.b, None, "model"), act, nspec, ospec),
                  Layout(act, ("model",)), split_model=True)
    return ctx.to(out, act), state


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def _rglru(ctx: _Ctx, p, x, cfg: ModelConfig, *, state: Optional[dict],
           decode: bool):
    """``rglru.rglru_apply`` on the mesh; (out, state), the state updated
    in place on its own shards.  Two bodies: the branch, the gate and the
    conv on the rank's channels; then, after one all-gather of the conv's
    output z over "model", the gates (z against the rank's columns of
    ``w_a`` and ``w_x``, in float32), the scan or the decode update, the
    merge and ``w_out``'s partial sum."""
    act = ctx.act()
    if rglru_mod._width(cfg) % ctx.tp:
        # whole on every "model" rank
        full = {n: P(*([None] * v.dim())) for n, v in _params(p).items()}
        sspec = {"h": P(ctx.b, None), "conv": P(ctx.b, None, None)}
        st, write_back = _moved(ctx, state, sspec)

        def whole(r, pl, xl, *sl):
            s_ = dict(zip(("h", "conv"), sl)) if sl else None
            return rglru_mod.rglru_apply(pl, xl, cfg, state=s_,
                                         decode=decode)[0]
        args = (_tree_map_pair(ctx.to, _params(p), full), x) + (
            (st["h"], st["conv"]) if st else ())
        specs = (full, act) + ((sspec["h"], sspec["conv"]) if st else ())
        out = ctx.run(whole, args, specs, act, split_model=False,
                      no_grad=tuple(range(2, len(args))))
        write_back()
        return out, state

    ch = P(ctx.b, None, "model")                    # [B, S, W] by channel
    in_specs = {"w_branch": P(None, "model"), "w_gate": P(None, "model"),
                "conv_w": P(None, "model"), "conv_b": P("model")}
    sspec = {"h": P(ctx.b, "model"), "conv": ch}
    st, write_back = _moved(ctx, state, sspec)

    def conv(r, pl, xl, *cl):
        return rglru_mod.rglru_conv(pl, xl, cfg, conv=cl[0] if cl else None,
                                    decode=decode)

    rglru_mod.check_call(x.shape[1], state, decode)
    pc = _tree_map_pair(ctx.to, _params(p), in_specs)
    args = (pc, x) + ((st["conv"],) if st else ())
    z, gate = ctx.run(conv, args, (in_specs, act) + ((ch,) if st else ()),
                      (ch, ch), split_model=True,
                      no_grad=tuple(range(2, len(args))))
    z_all = ctx.to(z, act)

    g_specs = {"w_a": P(None, "model"), "w_x": P(None, "model"),
               "b_a": P("model"), "b_x": P("model"), "lam": P("model"),
               "w_out": P("model", None)}

    def lru(r, pl, za, zl, gl, *hl):
        # the gates of the rank's channels read all of z
        return rglru_mod.rglru_recur(pl, za, zl, gl, cfg,
                                     h=hl[0] if hl else None, decode=decode)

    pg = _tree_map_pair(ctx.to, _params(p), g_specs)
    args = (pg, z_all, z, gate) + ((st["h"],) if st else ())
    specs = (g_specs, act, ch, ch) + ((sspec["h"],) if st else ())
    out = ctx.run(lru, args, specs, Layout(act, ("model",)),
                  split_model=True, no_grad=tuple(range(4, len(args))))
    write_back()
    return ctx.to(out, act), state


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe(ctx: _Ctx, p, x, cfg: ModelConfig):
    """``moe.moe_apply`` on the mesh; (y, aux).  The route on each rank's
    batch rows (replicated over "model"); then ``moe.experts`` on the same
    rows, with every expert's weights gathered over "data" and the rank's
    F columns (a partial sum over "model"), its dispatch and combine local
    to the batch shard; the shared experts through ``_mlp``.  The aux loss
    from the first choices' counts and the probabilities' sums reduced
    over the batch axes.  ``moe.experts.calls`` and ``.kept`` count once
    per rank in serving (each rank records its batch rows' (kept, all):
    the "model" ranks of a batch shard record the same rows), once per
    layer under autograd."""
    e = cfg.moe_num_experts
    act = ctx.act()
    b, s, _ = x.shape
    rspec = {"router": P(None, None)}
    one = P(None)

    def route(r, pl, xl):
        probs, top_w, top_e, _ = moe_mod.route(pl, xl, cfg)
        first = F.one_hot(top_e[..., 0], e).float()
        return top_w, top_e, first.sum((0, 1)), probs.sum((0, 1))

    top_w, top_e, n_first, p_sum = ctx.run(
        route, (_tree_map_pair(ctx.to, _params(p), rspec), x),
        (rspec, act), (act, act, Layout(one, ctx.baxes),
                       Layout(one, ctx.baxes)), split_model=False)
    n_first, p_sum = ctx.to(n_first, one), ctx.to(p_sum, one)
    aux = e * torch.sum((n_first / (b * s)) * (p_sum / (b * s)))

    f_col = "model" if cfg.expert_d_ff % ctx.tp == 0 else None
    especs = {"wi": P(None, None, None, f_col), "wo": P(None, f_col, None)}
    cfg_routed = cfg.replace(moe_shared_experts=0)

    def experts(r, pl, xl, tw, te):
        return moe_mod.experts(pl, xl, tw, te, cfg_routed)[0]

    y = ctx.run(experts, (_tree_map_pair(ctx.to, _params(p), especs), x,
                          top_w, top_e),
                (especs, act, act, act),
                Layout(act, ("model",)) if f_col else act,
                split_model=f_col is not None, no_grad=(3,))
    y = ctx.to(y, act)
    if cfg.moe_shared_experts:
        y = y + _mlp(ctx, p["shared"], x, cfg)
    return y, aux


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def _batch(ctx: _Ctx, t):
    """A batch-major input as a DTensor over the batch axes (from a plain
    tensor, each rank its own rows)."""
    if dist.is_dtensor(t):
        return ctx.to(t, ctx.act(t.dim()))
    return dist.distribute(t, ctx.mesh,
                           dist.placements(ctx.mesh, ctx.act(t.dim())))


def apply_layer(ctx: _Ctx, p, x, cfg: ModelConfig, sig: tuple, *,
                pos_offset: int = 0, cache: Optional[dict] = None,
                decode: bool = False, use_kernel: bool = True,
                memory=None, cross_cache: Optional[dict] = None):
    """``transformer.apply_layer`` on the mesh: x [B, S, D] laid out as
    ``ctx.act()``; the cache updated in place; the cross-attention over
    ``memory`` or ``cross_cache`` where the block has one and either is
    given.  Returns (x, aux): the MoE FFN's load-balance loss (a
    replicated scalar DTensor), 0.0 for any other layer."""
    kind, ffn = sig
    hn = _rmsnorm(ctx, p["ln1"], x, cfg.norm_eps)
    if kind == "ssd":
        mix, _ = _ssd(ctx, p["mixer"], hn, cfg, state=cache, decode=decode,
                      use_kernel=use_kernel)
    elif kind == "rglru":
        mix, _ = _rglru(ctx, p["mixer"], hn, cfg, state=cache, decode=decode)
    else:
        mix, _ = _attention(ctx, p["mixer"], hn, cfg, kind=kind,
                            pos_offset=pos_offset, cache=cache,
                            decode=decode, use_kernel=use_kernel)
    x = x + mix
    if "cross" in p and (memory is not None or cross_cache is not None):
        x = x + _cross(ctx, p["cross"],
                       _rmsnorm(ctx, p["ln_cross"], x, cfg.norm_eps), memory,
                       cfg, cache=cross_cache, decode=decode,
                       use_kernel=use_kernel)
    aux = 0.0
    if ffn != "none":
        h2 = _rmsnorm(ctx, p["ln2"], x, cfg.norm_eps)
        if ffn == "moe":
            y, aux = _moe(ctx, p["ffn"], h2, cfg)
        else:
            y = _mlp(ctx, p["ffn"], h2, cfg)
        x = x + y
    return _constrained(x), aux


def _constrained(x):
    """x [B, S, D] constrained to the activations' logical axes."""
    return dist.constrain(x, (dist.batch_logical(), "seq", None))


def hidden(params, tokens, cfg: ModelConfig, *, pos_offset: int = 0,
           caches: Optional[list] = None, decode: bool = False,
           use_kernel: bool = True):
    """``transformer._hidden_aux`` on the mesh: (h [B, S, D], caches, the
    step's ``_Ctx``, aux)."""
    from repro_torch.models.transformer import layer_sigs
    check_sharded(cfg)
    ctx = _Ctx(tokens.shape[0])
    tokens = _batch(ctx, tokens)
    x = _constrained(_embed(ctx, params["embed"], tokens, cfg))
    aux = 0.0
    for i, sig in enumerate(layer_sigs(cfg)):
        x, layer_aux = apply_layer(
            ctx, params["layers"][i], x, cfg, sig, pos_offset=pos_offset,
            cache=None if caches is None else caches[i], decode=decode,
            use_kernel=use_kernel)
        aux = aux + layer_aux
    return _rmsnorm(ctx, params["ln_f"], x, cfg.norm_eps), caches, ctx, aux


def forward(params, tokens, cfg: ModelConfig, *, pos_offset: int = 0,
            caches: Optional[list] = None, decode: bool = False,
            use_kernel: bool = True):
    """(logits [B, S, V] f32, the vocab over "model" where tp divides it,
    caches updated in place, aux: the MoE layers' load-balance losses
    summed, h: the final normed hidden state [B, S, D])."""
    h, caches, ctx, aux = hidden(params, tokens, cfg, pos_offset=pos_offset,
                                 caches=caches, decode=decode,
                                 use_kernel=use_kernel)
    return _logits(ctx, params, h, cfg)[0], caches, aux, h


def lm_loss(params, tokens, cfg: ModelConfig, sample_weights=None,
            use_kernel: bool = False):
    """``transformer.lm_loss`` on the mesh (the next-token loss, plus
    ``router_aux_weight`` times the summed aux loss of an MoE config; no
    MTP): a replicated scalar DTensor."""
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    h, _, ctx, aux = hidden(params, inputs, cfg, use_kernel=use_kernel)
    logits, split = _logits(ctx, params, h, cfg)
    labels = _batch(ctx, labels)
    if sample_weights is not None:
        sample_weights = _batch(ctx, sample_weights)
    loss = _xent(ctx, logits, split, labels, sample_weights)
    if cfg.moe_num_experts:
        loss = loss + cfg.router_aux_weight * aux
    return loss


# ---------------------------------------------------------------------------
# The encoder-decoder
# ---------------------------------------------------------------------------

def encode(params, frames, cfg: ModelConfig, *, use_kernel: bool = True):
    """``encdec.encode`` on the mesh: the frames [B, S, D] over the batch
    axes (no embedding), the bidirectional ``enc_attn`` blocks (K3
    non-causal on each rank's heads), the norm: memory [B, S, D]."""
    check_sharded(cfg)
    ctx = _Ctx(frames.shape[0])
    x = _constrained(_batch(ctx, frames.to(cfg.compute_dtype)))
    for p in params["enc_layers"]:
        x, _ = apply_layer(ctx, p, x, cfg, ENC_SIG, use_kernel=use_kernel)
    return _rmsnorm(ctx, params["enc_ln_f"], x, cfg.norm_eps)


def decode_hidden(params, memory, tokens, cfg: ModelConfig,
                  caches: Optional[list] = None, *,
                  cross_caches: Optional[list] = None, pos_offset: int = 0,
                  decode: bool = False, use_kernel: bool = True):
    """``encdec._decode_hidden`` on the mesh (with ``decode``, the blocks
    of ``encdec.decode_step``): (h [B, S, D], the step's ``_Ctx``)."""
    check_sharded(cfg)
    ctx = _Ctx(tokens.shape[0])
    tokens = _batch(ctx, tokens)
    x = _constrained(_embed(ctx, params["embed"], tokens, cfg))
    for i, p in enumerate(params["dec_layers"]):
        x, _ = apply_layer(
            ctx, p, x, cfg, DEC_SIG, pos_offset=pos_offset,
            cache=None if caches is None else caches[i], decode=decode,
            memory=memory,
            cross_cache=None if cross_caches is None else cross_caches[i],
            use_kernel=use_kernel)
    return _rmsnorm(ctx, params["ln_f"], x, cfg.norm_eps), ctx


def decode_logits(params, memory, tokens, cfg: ModelConfig,
                  caches: Optional[list] = None, **kw):
    """``encdec.decode_train`` (or, with ``decode=True``,
    ``encdec.decode_step``) on the mesh: logits [B, S, V] f32, the vocab
    over "model" where tp divides it."""
    h, ctx = decode_hidden(params, memory, tokens, cfg, caches, **kw)
    return _logits(ctx, params, h, cfg)[0]


def cross_caches(params, memory, cfg: ModelConfig) -> list:
    """``encdec.build_cross_caches`` on the mesh."""
    ctx = _Ctx(memory.shape[0])
    return [_cross_cache(ctx, p["cross"], memory, cfg)
            for p in params["dec_layers"]]


def seq2seq_loss(params, frames, tokens, cfg: ModelConfig,
                 sample_weights=None, use_kernel: bool = False):
    """``encdec.seq2seq_loss`` on the mesh: a replicated scalar
    DTensor."""
    memory = encode(params, frames, cfg, use_kernel=use_kernel)
    h, ctx = decode_hidden(params, memory, tokens[:, :-1], cfg,
                           use_kernel=use_kernel)
    logits, split = _logits(ctx, params, h, cfg)
    labels = _batch(ctx, tokens[:, 1:])
    if sample_weights is not None:
        sample_weights = _batch(ctx, sample_weights)
    return _xent(ctx, logits, split, labels, sample_weights)
