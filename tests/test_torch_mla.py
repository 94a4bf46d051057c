"""The port's multi-head latent attention (MLA) and multi-token-prediction
(MTP) head, DeepSeek-V3's, on the CPU against the reference's
``repro.models.attention`` and ``repro.models.transformer``.

The same numpy-seeded inputs, and weights carried across from the
reference's ``PRNGKey`` draws (``lm_params_from_jax`` for whole models),
go through both at deepseek-v3-671b's smoke width (2 layers, the first a
dense lead layer, the second MoE with 4 experts, top 2, one shared
expert; 4 heads, q_lora 64, kv_lora 64, nope 32, rope 16, v 32: q.k width
48, v width 32), with and without the q bottleneck (``q_lora_rank=0``):
``mla_apply``'s expanded prefill through K3's plain version, its
weight-absorbed decode and the latent caches, the absorbed decode against
the expanded form, ``mtp_logits``, ``lm_loss`` with the MTP term and its
gradient, the MTP label alignment (the reference's), the ``mtp`` subtree
through the stacked layout and the checkpoint, and ``moe_apply`` at
top 8 of 16 experts with a shared expert.  The OTA-FL train step on the
reference's replayed draws rides ``torch_ref.TRAIN_CASES``
(``test_torch_train.py``); the serve slice, ``test_torch_lm.py``'s
deepseek variants.

Tolerances: float32 throughout.  One MLA layer's output and the caches at
rtol 1e-5 / atol 1e-6 (products of widths D, 64 and 48 summed in another
order by XLA and PyTorch); the absorbed decode against the expanded form
within 1e-5 of its largest (the two forms sum in different orders: the
reference's own pair agrees to 7.2e-7 of 3.09); logits at rtol 1e-4 /
atol 1e-5 (``test_torch_lm.py``'s); the loss at rtol 1e-5 / atol 1e-6 and
its gradients at rtol 1e-4 / atol 1e-6 (``test_torch_train.py``'s); the
MoE's slots and drops bitwise, its output at rtol 1e-5 / atol 1e-6 and
aux at rtol 1e-6 (``test_torch_moe.py``'s).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import checkpoint as jckpt
from repro.models import attention as jattn
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.models.param import init_params as jinit
from repro.models.registry import build_bundle as jbuild
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.models.param import (ParamTree, lm_params_from_jax,
                                      lm_params_to_stacked, map_named,
                                      param_leaves, trainable,
                                      tree_param_count)
from repro_torch.models.registry import build_bundle as tbuild

CPU = torch.device("cpu")
ARCH = "deepseek-v3-671b"
LAYER_TOL = dict(rtol=1e-5, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
FORMS_SHARE = 1e-5
EXPERT_TOL = dict(rtol=1e-5, atol=1e-6)
AUX_RTOL = 1e-6
# smoke overrides: the q bottleneck (deepseek's own) or none
Q_LORA = {"q_lora": {}, "no_q_lora": dict(q_lora_rank=0)}


def _cfgs(**kw):
    return (jconfigs.get_config(ARCH).smoke(**kw),
            tconfigs.get_config(ARCH).smoke(**kw))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(x):
    return np.asarray(x.detach().float().numpy() if torch.is_tensor(x)
                      else x, np.float32)


def _mla_params(jcfg, seed=0):
    """The reference's ``mla_def`` init as numpy, its norm weights (1 at
    init) perturbed by seeded noise so that they are held too; and the
    same numbers as a ParamTree."""
    rng = np.random.default_rng(seed)

    def one(path, a):
        a = np.asarray(a, np.float32)
        if "norm" in jax.tree_util.keystr(path):
            a = a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        return a
    jp = jax.tree_util.tree_map_with_path(one, jinit(
        jattn.mla_def(jcfg, tp=1), jax.random.PRNGKey(seed)))
    return jp, ParamTree(jax.tree.map(torch.from_numpy, jp))


def _model(jcfg, tcfg, seed=0):
    jp = jax.tree.map(np.asarray, jbuild(jcfg, tp=1, dp=1).init(
        jax.random.PRNGKey(seed)))
    return jp, lm_params_from_jax(tcfg, jp)


# ---------------------------------------------------------------------------
# one MLA layer: the expanded prefill, the absorbed decode, the caches
# ---------------------------------------------------------------------------

def _prefill_and_decode(variant, s, steps, max_len, offset=0):
    """One MLA layer on both sides: a prefill of ``s`` tokens at
    ``offset`` into a cache of ``max_len``, then ``steps`` decode steps.
    Yields (label, port out, reference out, port cache, reference
    cache)."""
    jcfg, tcfg = _cfgs(**Q_LORA[variant])
    jp, tp = _mla_params(jcfg, seed=1)
    x = _rand((2, s + steps, jcfg.d_model), 2)
    jcache = jattn.init_mla_cache(jcfg, 2, max_len)
    tcache = tattn.init_mla_cache(tcfg, 2, max_len, CPU)
    assert {n: tuple(c.shape) for n, c in tcache.items()} \
        == {n: c.shape for n, c in jcache.items()}
    calls = tref.attention_ref.calls
    want, jcache = jattn.mla_apply(jp, jnp.asarray(x[:, :s]), jcfg,
                                   pos_offset=offset, cache=jcache)
    got, out_cache = tattn.mla_apply(tp, torch.from_numpy(x[:, :s]), tcfg,
                                     pos_offset=offset, cache=tcache)
    assert out_cache is tcache                      # in place
    assert tref.attention_ref.calls == calls + 1    # K3's plain version
    yield "prefill", got, want, tcache, jcache
    for i in range(steps):
        pos = offset + s + i
        xs = x[:, s + i:s + i + 1]
        want, jcache = jattn.mla_apply(jp, jnp.asarray(xs), jcfg,
                                       pos_offset=pos, cache=jcache,
                                       decode=True)
        got, _ = tattn.mla_apply(tp, torch.from_numpy(xs), tcfg,
                                 pos_offset=pos, cache=tcache, decode=True)
        yield f"decode {i}", got, want, tcache, jcache
    assert tref.attention_ref.calls == calls + 1    # decode: plain torch


def _close_caches(tcache, jcache):
    for n in ("ckv", "krope"):
        np.testing.assert_allclose(_np(tcache[n]), _np(jcache[n]),
                                   **LAYER_TOL, err_msg=n)


@pytest.mark.parametrize("variant", list(Q_LORA))
def test_mla_prefill_matches_reference(variant):
    """The expanded form (q.k width 48, v width 32) through the wrapper's
    plain version, and the latents it writes into the cache."""
    (_, got, want, tcache, jcache), = _prefill_and_decode(variant, 21, 0, 30)
    assert got.shape == (2, 21, _cfgs()[1].d_model)
    np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL)
    _close_caches(tcache, jcache)


@pytest.mark.parametrize("variant", list(Q_LORA))
def test_mla_absorbed_decode_and_caches_match_reference(variant):
    """Three weight-absorbed decode steps against the latent cache after a
    prefill of 16: each step's output and the whole cache."""
    for label, got, want, tcache, jcache in _prefill_and_decode(
            variant, 16, 3, 24):
        np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL,
                                   err_msg=label)
        _close_caches(tcache, jcache)


def test_mla_prefill_at_an_offset_matches_reference():
    """A prefill segment at position 5 (RoPE at 5.., the cache written from
    slot 5), then a decode step reading slots 0..17."""
    for label, got, want, tcache, jcache in _prefill_and_decode(
            "q_lora", 12, 1, 20, offset=5):
        np.testing.assert_allclose(_np(got), _np(want), **LAYER_TOL,
                                   err_msg=label)
        _close_caches(tcache, jcache)


@pytest.mark.parametrize("variant", list(Q_LORA))
def test_mla_absorbed_decode_equals_the_expanded_form(variant):
    """Token 16 decoded against the cache of a 16-token prefill (the
    absorbed form) equals row 16 of one expanded prefill over 17 tokens,
    within 1e-5 of its largest: the same function summed in another
    order (the check ``chip_smoke.py`` repeats at full width)."""
    _, tcfg = _cfgs(**Q_LORA[variant])
    jcfg, _ = _cfgs(**Q_LORA[variant])
    _, tp = _mla_params(jcfg, seed=3)
    x = torch.from_numpy(_rand((2, 17, tcfg.d_model), 4))
    cache = tattn.init_mla_cache(tcfg, 2, 17, CPU)
    tattn.mla_apply(tp, x[:, :16], tcfg, cache=cache)
    got, _ = tattn.mla_apply(tp, x[:, 16:], tcfg, pos_offset=16,
                             cache=cache, decode=True)
    full, _ = tattn.mla_apply(tp, x, tcfg)
    want = full[:, 16:]
    assert float((got - want).abs().max()) \
        <= FORMS_SHARE * float(want.abs().max())


def test_mla_cache_write_past_the_end_raises():
    _, tcfg = _cfgs()
    cache = tattn.init_mla_cache(tcfg, 1, 4, CPU)
    with pytest.raises(ValueError, match="past"):
        tattn._latent_write(cache, torch.ones(1, 2, tcfg.kv_lora_rank),
                            torch.ones(1, 2, tcfg.qk_rope_head_dim), 3)


# ---------------------------------------------------------------------------
# the MTP head, the loss and its gradient
# ---------------------------------------------------------------------------

def test_mtp_logits_match_reference():
    """``mtp_logits`` on the reference's final hidden state and tokens:
    [B, S - 1, V] against the reference's."""
    jcfg, tcfg = _cfgs()
    jp, tp = _model(jcfg, tcfg)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 19))
    _, _, _, jh = jax.jit(lambda p, t: jtfm.forward(
        p, t, jcfg, return_hidden=True))(jp, jnp.asarray(toks))
    _, _, _, th = ttfm.forward_aux(tp, torch.from_numpy(toks), tcfg,
                                   return_hidden=True)
    np.testing.assert_allclose(_np(th), _np(jh), **LOGIT_TOL)
    want = jax.jit(lambda p, h, t: jtfm.mtp_logits(p, h, t, jcfg))(
        jp, jh, jnp.asarray(toks))
    got = ttfm.mtp_logits(tp, torch.from_numpy(_np(jh)),
                          torch.from_numpy(toks), tcfg)
    assert got.shape == (2, 18, tcfg.padded_vocab)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **LOGIT_TOL)


@pytest.mark.parametrize("variant", list(Q_LORA))
def test_lm_loss_with_mtp_and_its_gradient_match_reference(variant):
    """The loss (cross-entropy + router_aux_weight x aux + mtp_loss_weight x
    the MTP cross-entropy) with per-sample weights, and its gradient leaf
    by leaf in the reference's stacked layout, the ``mtp`` subtree among
    them, against ``jax.grad``."""
    jcfg, tcfg = _cfgs(**Q_LORA[variant])
    jp = jbuild(jcfg, tp=1, dp=1).init(jax.random.PRNGKey(1))
    tp = lm_params_from_jax(tcfg, jax.tree.map(np.asarray, jp))
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (4, 26))
    w = np.array([0.0, 1.5, 2.0, 0.5], np.float32)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda p, t, sw: jtfm.lm_loss(p, t, jcfg, sample_weights=sw)))(
        jp, jnp.asarray(toks), jnp.asarray(w))
    view, leaves = trainable(tp)
    loss = ttfm.lm_loss(view, torch.from_numpy(toks), tcfg,
                        sample_weights=torch.from_numpy(w))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               **LOSS_TOL)
    by_name = dict(zip(leaves, grads))
    got = tckpt._flatten(lm_params_to_stacked(
        tcfg, map_named(tp, lambda name, _: by_name[name])))
    want = jckpt._flatten(jgrad)
    assert sorted(got) == sorted(want)
    assert any(k.startswith("mtp/layer/mixer/") for k in want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **GRAD_TOL, err_msg=k)


def test_mtp_labels_keep_the_reference_alignment():
    """The reference trains MTP position i (h_i and input token i + 1) on
    ``labels[:, 2:]``, input token i + 3, one later than its docstring's
    i + 2: the port's loss is the next-token cross-entropy + the aux term
    + 0.3 x the MTP cross-entropy on exactly those labels, and not on the
    docstring's.  With 2 labels or fewer the MTP term is left out, as the
    reference's guard does."""
    jcfg, tcfg = _cfgs()
    jp, tp = _model(jcfg, tcfg, seed=2)
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, tcfg.vocab_size, (2, 15)))
    inputs, labels = toks[:, :-1], toks[:, 1:]
    with torch.no_grad():
        loss = ttfm.lm_loss(tp, toks, tcfg)
        logits, _, aux, h = ttfm.forward_aux(tp, inputs, tcfg,
                                             return_hidden=True)
        mtp = ttfm.mtp_logits(tp, h, inputs, tcfg)
        base = ttfm.softmax_xent(logits, labels, tcfg.padded_vocab) \
            + tcfg.router_aux_weight * aux

        def xent(lg, lab):
            return ttfm.softmax_xent(lg, lab, tcfg.padded_vocab)
        theirs = base + tcfg.mtp_loss_weight * xent(mtp[:, :12],
                                                    labels[:, 2:])
        docstring = base + tcfg.mtp_loss_weight * xent(mtp, labels[:, 1:])
    assert tcfg.mtp_loss_weight == 0.3
    np.testing.assert_allclose(float(loss), float(theirs), rtol=1e-6)
    assert abs(float(loss) - float(docstring)) > 1e-3
    want = jax.jit(lambda p, t: jtfm.lm_loss(p, t, jcfg))(
        jp, jnp.asarray(toks.numpy()))
    np.testing.assert_allclose(float(loss), float(want), **LOSS_TOL)
    short = toks[:, :3]                 # 2 labels: no MTP term
    with torch.no_grad():
        lg, _, aux = ttfm.forward_aux(tp, short[:, :-1], tcfg)
        np.testing.assert_allclose(
            float(ttfm.lm_loss(tp, short, tcfg)),
            float(ttfm.softmax_xent(lg, short[:, 1:], tcfg.padded_vocab)
                  + tcfg.router_aux_weight * aux), rtol=1e-6)


# ---------------------------------------------------------------------------
# layout: the mtp subtree, the checkpoint, parameter counts
# ---------------------------------------------------------------------------

def test_mtp_subtree_round_trips_the_stacked_layout_and_checkpoint(tmp_path):
    """lm_params_to_stacked(lm_params_from_jax(tree)) is the reference's
    tree leaf for leaf, ``lead`` (the dense layer), ``scan`` (the MoE
    layer) and ``mtp`` among them; the port's archive restores in the
    reference's ``restore`` bitwise and back."""
    jcfg, tcfg = _cfgs()
    jp, tp = _model(jcfg, tcfg)
    assert set(jp["mtp"]) == {"proj", "ln_in", "layer", "ln_out"}
    back = tckpt._flatten(lm_params_to_stacked(tcfg, tp))
    want = jckpt._flatten(jp)
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    path = str(tmp_path / "port.npz")
    tckpt.save_lm(path, tcfg, tp, meta={"arch": tcfg.name})
    restored = jckpt.restore(path, jbuild(jcfg, tp=1, dp=1).init(
        jax.random.PRNGKey(7)))
    got = jckpt._flatten(restored)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k],
                                      err_msg=k)
    again = tckpt.restore_lm(path, tcfg)
    for (n1, a), (n2, b) in zip(param_leaves(tp).items(),
                                param_leaves(again).items()):
        assert n1 == n2 and torch.equal(a, b), n1


def test_deepseek_builds_and_counts_the_reference_parameters():
    """``get_config`` builds the model (MLA and MTP are no longer refused;
    another attention kind still is); the full-width defs count the
    reference bundle's parameters at 61 layers (~671B) and at the depths
    the card runs: 4 layers (3 dense lead + 1 MoE) and 2."""
    cfg = tconfigs.get_config(ARCH)
    ttfm.check_supported(cfg)
    for n, want in ((61, 671_712_662_528), (4, 15_797_359_616),
                    (2, 3_706_590_208)):
        c = cfg.replace(n_layers=n)
        count = tree_param_count(ttfm.model_defs(c))
        assert count == jbuild(jconfigs.get_config(ARCH).replace(
            n_layers=n), tp=1, dp=1).num_params
        assert count == want
    assert ttfm.layer_sigs(cfg.replace(n_layers=4)) \
        == [("attn", "dense")] * 3 + [("attn", "moe")]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttfm.check_supported(cfg.replace(attn_kind="linear"))
    bundle = tbuild(cfg.smoke(), CPU)
    assert "mtp" in bundle.defs


# ---------------------------------------------------------------------------
# the MoE at top 8 with a shared expert
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [1.25, 2.0, 0.5])
def test_moe_apply_at_top8_matches_reference(cf):
    """deepseek's smoke MoE at E 16, K 8, one shared expert: ``experts`` on
    the reference's own routes (slots and drops bitwise per row; the
    combine adds a token's 8 terms one at a time), then ``moe_apply``
    whole; at the default capacity factor and at 0.5 assignments are
    dropped, at E / K = 2 none."""
    kw = dict(moe_num_experts=16, moe_top_k=8, capacity_factor=cf)
    jcfg, tcfg = _cfgs(**kw)
    assert tcfg.moe_shared_experts == 1
    jp = jax.tree.map(lambda a: np.asarray(a, np.float32),
                      jinit(jmoe.moe_def(jcfg, tp=1, dp=1),
                            jax.random.PRNGKey(8)))
    tp = ParamTree(jax.tree.map(torch.from_numpy, jp))
    b, s = 2, 37
    x = _rand((b, s, jcfg.d_model), 9)
    logits = jnp.einsum("bsd,de->bse", jnp.asarray(x),
                        jnp.asarray(jp["router"]))
    top_w, top_e = jax.lax.top_k(jax.nn.softmax(logits, -1), 8)
    top_w = top_w / jnp.sum(top_w, -1, keepdims=True)
    want, waux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    y, slot, keep = tmoe.experts(tp, torch.from_numpy(x),
                                 torch.from_numpy(np.asarray(top_w)),
                                 torch.from_numpy(np.asarray(top_e)).long(),
                                 tcfg)
    np.testing.assert_allclose(_np(y), _np(want), **EXPERT_TOL)
    cap = jmoe.expert_capacity(jcfg, s)
    for r in range(b):
        ws, wk = jmoe._dispatch_indices(top_e[r].reshape(-1), cap, 16)
        np.testing.assert_array_equal(slot[r].numpy(), np.asarray(ws))
        np.testing.assert_array_equal(keep[r].numpy(), np.asarray(wk))
    assert bool(keep.all()) == (cf == 2.0)
    y2, aux = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(_np(y2), _np(want), **EXPERT_TOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=AUX_RTOL)
