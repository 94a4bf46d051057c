"""The decoder-only models on a mesh of ranks (module 12b): the dense GQA
decoders and Mamba-2, with parameters, caches and activations as DTensors
laid out by the reference's specs and logical-axis rules.

``models.transformer`` hands a forward or a loss here when its parameters
are DTensors and a mesh is bound (``distributed.mesh_rules``); one card
never comes here.  The layout is the reference's:

* parameters as ``launch.steps.shard_params`` lays them out, by their
  ``ParamDef.spec``: column-parallel weights' out-dim over "model" and
  in-dim over "data" (FSDP), row-parallel ones the transpose;
* activations [B, S, D] with the batch over the batch axes ("data", or
  ("pod", "data")), when it divides them, and replicated over "model"
  (``distributed.constrain`` after the embedding and after each layer, as
  ``repro/models/transformer.py:212``, ``:279``).

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
``LocalTensorMode``: one launch per rank and layer).

Mamba-2 (``ssd``): ``in_proj``'s out-dim [z, xBC, dt] is sharded over
"model" as one axis (the reference's spec), and its parts do not fall on
the shard boundaries; so it is gathered whole, and each rank projects
onto the columns of its nheads / tp heads (z, x, dt) and the shared B and
C (ngroups 1); the conv, the scan (K4) and the gate run on those heads;
the gated norm's sum of squares over d_inner is one all-reduce, and
``out_proj`` is row-parallel (its rows are the heads').  The conv window
cache is sharded over channels that do not fall on heads either: it is
gathered before the mixer and written back after it.

Any cache whose layout the step cannot compute on (a KV cache sharded
over its sequence, the long-context rule "kv_seq" over "data") is
gathered to the layout it needs first and written back after.

Refused by name (``check_sharded``): the RG-LRU, MoE, MLA, MTP and the
encoder-decoder (ROADMAP.md §1, 12c).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import distributed as dist
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import attention as attn_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_rope, dense, embed, mlp,
                                       rmsnorm, unembed)
from repro_torch.models.param import P

Layout = dist.Layout


def check_sharded(cfg: ModelConfig) -> None:
    """Raise for what does not run on a mesh yet (ROADMAP.md §1, 12c)."""
    missing = []
    if cfg.is_enc_dec:
        missing.append("the encoder-decoder")
    if cfg.attn_kind != "gqa":
        missing.append(f"{cfg.attn_kind} attention")
    if cfg.moe_num_experts:
        missing.append("MoE")
    if cfg.mtp_depth:
        missing.append("MTP")
    if cfg.input_mode != "tokens":
        missing.append(f"{cfg.input_mode} inputs")
    missing += [f"{k} mixer" for k in sorted(set(cfg.block_pattern))
                if k not in ("attn", "swa", "local", "ssd")]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not sharded over a mesh yet "
            "(ROADMAP.md §1, 12c)")


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

    def select_heads(r, device):
        """Rank r's q heads' KV heads out of all KH (by index: one KV
        head when the rank's heads share it, else one per q head)."""
        g = h // kh
        if mode != "heads" or kv_split:
            return None
        if g % hl == 0:
            idx = _arange(1, (r * hl) // g, device)
        else:
            idx = (_arange(hl, r * hl, device)) // g
        return lambda t: torch.index_select(t, 2, idx)

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
                                  select=select_heads(r, xl.device),
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


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def _mlp(ctx: _Ctx, p, x, cfg: ModelConfig):
    """The dense MLP: its width over "model" (a partial sum, one
    all-reduce), or whole where tp does not divide it."""
    gated = cfg.ffn_kind in ("swiglu", "geglu")
    split = cfg.d_ff % ctx.tp == 0
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
                decode: bool = False, use_kernel: bool = True):
    """``transformer.apply_layer`` on the mesh (no cross-attention, no
    MoE): x [B, S, D] laid out as ``ctx.act()``; the cache updated in
    place."""
    kind, ffn = sig
    hn = _rmsnorm(ctx, p["ln1"], x, cfg.norm_eps)
    if kind == "ssd":
        mix, _ = _ssd(ctx, p["mixer"], hn, cfg, state=cache, decode=decode,
                      use_kernel=use_kernel)
    else:
        mix, _ = _attention(ctx, p["mixer"], hn, cfg, kind=kind,
                            pos_offset=pos_offset, cache=cache,
                            decode=decode, use_kernel=use_kernel)
    x = x + mix
    if ffn != "none":
        x = x + _mlp(ctx, p["ffn"], _rmsnorm(ctx, p["ln2"], x, cfg.norm_eps),
                     cfg)
    return dist.constrain(x, (dist.batch_logical(), "seq", None))


def hidden(params, tokens, cfg: ModelConfig, *, pos_offset: int = 0,
           caches: Optional[list] = None, decode: bool = False,
           use_kernel: bool = True):
    """``transformer._hidden_aux`` on the mesh: (h [B, S, D], caches, the
    step's ``_Ctx``)."""
    from repro_torch.models.transformer import layer_sigs
    check_sharded(cfg)
    ctx = _Ctx(tokens.shape[0])
    tokens = _batch(ctx, tokens)
    x = _embed(ctx, params["embed"], tokens, cfg)
    x = dist.constrain(x, (dist.batch_logical(), "seq", None))
    for i, sig in enumerate(layer_sigs(cfg)):
        x = apply_layer(ctx, params["layers"][i], x, cfg, sig,
                        pos_offset=pos_offset,
                        cache=None if caches is None else caches[i],
                        decode=decode, use_kernel=use_kernel)
    return _rmsnorm(ctx, params["ln_f"], x, cfg.norm_eps), caches, ctx


def forward(params, tokens, cfg: ModelConfig, *, pos_offset: int = 0,
            caches: Optional[list] = None, decode: bool = False,
            use_kernel: bool = True):
    """(logits [B, S, V] f32, the vocab over "model" where tp divides it,
    caches updated in place)."""
    h, caches, ctx = hidden(params, tokens, cfg, pos_offset=pos_offset,
                            caches=caches, decode=decode,
                            use_kernel=use_kernel)
    return _logits(ctx, params, h, cfg)[0], caches


def lm_loss(params, tokens, cfg: ModelConfig, sample_weights=None,
            use_kernel: bool = False):
    """``transformer.lm_loss`` on the mesh (the next-token loss; no MoE
    aux, no MTP): a replicated scalar DTensor."""
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    h, _, ctx = hidden(params, inputs, cfg, use_kernel=use_kernel)
    logits, split = _logits(ctx, params, h, cfg)
    labels = _batch(ctx, labels)
    if sample_weights is not None:
        sample_weights = _batch(ctx, sample_weights)
    return _xent(ctx, logits, split, labels, sample_weights)
