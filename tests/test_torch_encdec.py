"""The port's encoder-decoder (seamless-m4t-medium's family) on the CPU
against the reference.

Module by module (the encoder's bidirectional ``enc_attn`` self-attention,
cross-attention from the memory with Sq < Sk and Sq > Sk and from a
cache, the cross cache, the encoder, the teacher-forced decoder with and
without self caches, the cross caches), then the whole serve slice: the
port's bundle against ``repro.models.registry.build_bundle(cfg.smoke(),
tp=1, dp=1)`` on the reference's own ``PRNGKey(0)`` weights, carried
across with ``encdec_params_from_jax``, and the same numpy frames and
prompts: the prefill logits and both caches, then 8 greedy decode steps,
their tokens and logits.  Then ``seq2seq_loss`` and its gradient against
``jax.grad`` of the reference's, the init laws, the full-width count and
the entry points.

The smoke config: 2 encoder and 2 decoder layers, d_model 256, 4 heads
over 2 KV heads, head_dim 64, float32.  The reference initializes norm
weights to 1; the tests perturb them with seeded noise, the same on both
sides, so that every norm is held too.

Tolerance: rtol 1e-4 / atol 1e-5, as ``test_torch_lm.py``: the same f32
math through 2 + 2 layers, with matmul and reduction sums taken in
another order by XLA and PyTorch; greedy tokens must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.models.param import init_params as jinit
from repro.models.registry import build_bundle as jbuild
from repro_torch import configs as tconfigs
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as tencdec
from repro_torch.models.param import (ParamTree, encdec_params_from_jax,
                                      trainable, tree_param_count)
from repro_torch.models.registry import build_bundle as tbuild
from repro_torch.profile_attention import SHAPES as K3_SHAPES
from repro_torch.profile_attention import bound, pairs
from torch_ref import one_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-4, atol=1e-5)
CPU = torch.device("cpu")
ARCH = "seamless-m4t-medium"


def _cfgs(**kw):
    return (jconfigs.get_config(ARCH).smoke(**kw),
            tconfigs.get_config(ARCH).smoke(**kw))


def _perturb(tree, seed=0):
    """Seeded noise on the norm weights (the reference's ones), as numpy;
    other leaves unchanged."""
    rng = np.random.default_rng(seed)

    def one(path, a):
        a = np.asarray(a, np.float32)
        if any(t in jax.tree_util.keystr(path) for t in ("ln", "norm")):
            a = a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(one, tree)


def _torch_tree(tree):
    return ParamTree(jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                                  tree))


def _np(x):
    return np.asarray(x.detach().float().numpy() if torch.is_tensor(x) else x,
                      np.float32)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _params(jcfg, tcfg, seed=0):
    jp = _perturb(jbuild(jcfg, tp=1, dp=1).init(jax.random.PRNGKey(seed)))
    return jp, encdec_params_from_jax(tcfg, jp)


# ---------------------------------------------------------------------------
# attention: the encoder's kind, cross-attention
# ---------------------------------------------------------------------------

def test_enc_attn_matches_reference():
    """Bidirectional self-attention, RoPE at 0..S-1, through K3's plain
    version (non-causal) once."""
    jcfg, tcfg = _cfgs()
    jp = _perturb(jinit(jattn.gqa_def(jcfg, tp=1), jax.random.PRNGKey(2)))
    x = _rand((2, 21, jcfg.d_model), 3)
    want, _ = jattn.gqa_apply(jp, jnp.asarray(x), jcfg, kind="enc_attn")
    calls = tref.attention_ref.calls
    got, cache = tattn.gqa_apply(_torch_tree(jp), torch.from_numpy(x), tcfg,
                                 kind="enc_attn")
    assert cache is None and tref.attention_ref.calls == calls + 1
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    causal, _ = tattn.gqa_apply(_torch_tree(jp), torch.from_numpy(x), tcfg)
    assert not np.allclose(_np(causal), _np(want), **TOL)


def test_enc_attn_with_a_cache_or_decode_raises():
    _, tcfg = _cfgs()
    p = _torch_tree(jinit(jattn.gqa_def(_cfgs()[0], tp=1),
                          jax.random.PRNGKey(2)))
    cache = tattn.init_kv_cache(tcfg, 1, 8, "attn", CPU)
    x = torch.zeros(1, 1, tcfg.d_model)
    for kw in (dict(cache=cache), dict(cache=cache, decode=True)):
        with pytest.raises(ValueError, match="enc_attn"):
            tattn.gqa_apply(p, x, tcfg, kind="enc_attn", **kw)


@pytest.mark.parametrize("sq,sk", [(7, 19), (23, 11), (1, 5)])
def test_cross_apply_from_memory_matches_reference(sq, sk):
    """Every query over every memory row, Sq < Sk and Sq > Sk: K3's plain
    version, non-causal, once (a prefill of one token too)."""
    jcfg, tcfg = _cfgs()
    jp = jinit(jattn.cross_def(jcfg, tp=1), jax.random.PRNGKey(4))
    x, mem = _rand((2, sq, jcfg.d_model), 5), _rand((2, sk, jcfg.d_model), 6)
    want = jattn.cross_apply(jp, jnp.asarray(x), jnp.asarray(mem), jcfg)
    calls = tref.attention_ref.calls
    got = tattn.cross_apply(_torch_tree(jp), torch.from_numpy(x),
                            torch.from_numpy(mem), tcfg)
    assert tref.attention_ref.calls == calls + 1
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_cross_cache_and_cross_apply_from_it_match_reference():
    """``cross_cache``'s K and V, then the prefill (K3's plain version) and
    a decode step (the uncounted ``grouped_attention``) reading them."""
    jcfg, tcfg = _cfgs()
    jp = jinit(jattn.cross_def(jcfg, tp=1), jax.random.PRNGKey(4))
    tp = _torch_tree(jp)
    mem = _rand((2, 17, jcfg.d_model), 7)
    jc = jattn.cross_cache(jp, jnp.asarray(mem), jcfg)
    tc = tattn.cross_cache(tp, torch.from_numpy(mem), tcfg)
    for n in ("k", "v"):
        assert tc[n].shape == jc[n].shape == (2, 17, 2, 64)
        np.testing.assert_allclose(_np(tc[n]), _np(jc[n]), **TOL)
    for sq, decode in ((9, False), (1, True)):
        x = _rand((2, sq, jcfg.d_model), 8 + sq)
        want = jattn.cross_apply(jp, jnp.asarray(x), None, jcfg, cache=jc)
        calls = tref.attention_ref.calls
        got = tattn.cross_apply(tp, torch.from_numpy(x), None, tcfg,
                                cache=tc, decode=decode)
        assert tref.attention_ref.calls == calls + (not decode)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_attention_bound_counts_every_pair_when_non_causal():
    """K3's bound (``profile_attention.bound``, which the card's rows
    print): the products of all Sq x Sk pairs when non-causal, the
    lower triangle when causal, and q, o over Sq, k, v over Sk."""
    shapes = {s.label: s for s in K3_SHAPES}
    card = "NVIDIA H100 80GB HBM3"
    assert pairs(1024, 1024, False, None) == 1024 * 1024
    assert pairs(1024, 1024, True, None) == 1024 * 1025 // 2
    assert pairs(128, 1024, False, None) == 128 * 1024
    enc = bound(shapes["seamless_encoder"], card)
    main = bound(shapes["main"], card)
    assert enc["flops"] == 4 * 8 * 16 * 64 * 1024 * 1024 \
        == 2 * main["flops"] - 4 * 8 * 16 * 64 * 1024
    assert enc["bytes"] == main["bytes"] and enc["bound_by"] == "operations"
    cross = shapes["seamless_cross"]
    assert (cross.s, cross.keys, cross.causal) == (128, 1024, False)
    row = bound(cross, card)
    assert row["flops"] == 4 * 8 * 16 * 64 * 128 * 1024
    assert row["bytes"] == 2 * 8 * 64 * (2 * 128 * 16 + 2 * 1024 * 16)
    assert row["bound_by"] == "bytes"
    assert bound(shapes["seamless_cross_f32"], card)["bytes"] \
        == 2 * row["bytes"]


# ---------------------------------------------------------------------------
# encoder, decoder, caches
# ---------------------------------------------------------------------------

def test_encode_matches_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    frames = _rand((2, 29, jcfg.d_model), 9)
    want = jencdec.encode(jp, jnp.asarray(frames), jcfg)
    calls = tref.attention_ref.calls
    got = tencdec.encode(tp, torch.from_numpy(frames), tcfg)
    assert tref.attention_ref.calls == calls + tcfg.encoder_layers
    assert got.shape == (2, 29, tcfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("with_caches", [False, True])
def test_decode_train_matches_reference(with_caches):
    """Teacher-forced logits over a memory longer than the tokens; with
    caches, the self caches it fills too."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    mem = _rand((2, 31, jcfg.d_model), 10)
    toks = _tokens((2, 13), jcfg.vocab_size, 11)
    if not with_caches:
        want = jencdec.decode_train(jp, jnp.asarray(mem), jnp.asarray(toks),
                                    jcfg)
        got = tencdec.decode_train(tp, torch.from_numpy(mem),
                                   torch.from_numpy(toks), tcfg)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        return
    jc = jencdec.init_decode_caches(jcfg, 2, 20)
    tc = tencdec.init_decode_caches(tcfg, 2, 20, CPU)
    want, jc = jencdec.decode_train(jp, jnp.asarray(mem), jnp.asarray(toks),
                                    jcfg, caches=jc)
    got, tc2 = tencdec.decode_train(tp, torch.from_numpy(mem),
                                    torch.from_numpy(toks), tcfg, caches=tc)
    assert tc2 is tc                                 # in place
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for i in range(tcfg.n_layers):
        for n in ("k", "v"):
            np.testing.assert_allclose(_np(tc[i][n]), _np(jc[n][i]), **TOL)


def test_build_cross_caches_matches_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    mem = _rand((2, 19, jcfg.d_model), 12)
    want = jencdec.build_cross_caches(jp, jnp.asarray(mem), jcfg)
    got = tencdec.build_cross_caches(tp, torch.from_numpy(mem), tcfg)
    assert len(got) == tcfg.n_layers
    for i, c in enumerate(got):
        for n in ("k", "v"):
            np.testing.assert_allclose(_np(c[n]), _np(want[n][i]), **TOL)


# ---------------------------------------------------------------------------
# the whole serve slice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s_frames,s", [(29, 37), (41, 13)])
def test_serve_slice_matches_reference_bundle(s_frames, s):
    """The bundle's prefill (frames, prompts) and 8 greedy decode steps.
    On the CPU the prefill takes K3's plain version once per encoder
    layer and twice per decoder layer (self and cross), K3 never; decode
    steps call no counted version."""
    jcfg, tcfg = _cfgs()
    jb, tb = jbuild(jcfg, tp=1, dp=1), tbuild(tcfg, CPU)
    assert tb.num_params == jb.num_params
    jp, tp = _params(jcfg, tcfg)
    b, steps = 2, 8
    frames = _rand((b, s_frames, jcfg.d_model), 13)
    prompts = _tokens((b, s), jcfg.vocab_size, 14)
    jcache, tcache = jb.init_caches(b, s + steps), tb.init_caches(b, s + steps)

    launches, calls = flash_attention.launches, tref.attention_ref.calls
    want, (jself, jcross) = jax.jit(jb.prefill)(
        jp, (jnp.asarray(frames), jnp.asarray(prompts, jnp.int32)), jcache)
    got, (tself, tcross) = tsteps.make_prefill_step(tb)(
        tp, (torch.from_numpy(frames), torch.from_numpy(prompts)), tcache)
    assert flash_attention.launches == launches
    assert tref.attention_ref.calls == calls + tcfg.encoder_layers \
        + 2 * tcfg.n_layers
    assert got.shape == (b, s, tcfg.padded_vocab)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for i in range(tcfg.n_layers):
        for n in ("k", "v"):
            np.testing.assert_allclose(_np(tself[i][n]), _np(jself[n][i]),
                                       **TOL)
            np.testing.assert_allclose(_np(tcross[i][n]), _np(jcross[n][i]),
                                       **TOL)

    jdecode, serve = jax.jit(jb.decode), tsteps.make_serve_step(tb)
    jcaches, tcaches = (jself, jcross), (tself, tcross)
    jtok = jnp.argmax(want[:, -1:], -1)
    ttok = torch.argmax(got[:, -1:], -1)
    calls = tref.attention_ref.calls
    for i in range(steps):
        wl, jcaches = jdecode(jp, jcaches, jtok, jnp.asarray(s + i))
        gl, _ = tb.decode(tp, ([{n: c.clone() for n, c in lc.items()}
                                for lc in tcaches[0]], tcaches[1]),
                          ttok, s + i)
        np.testing.assert_allclose(_np(gl), _np(wl), **TOL)
        jtok = jnp.argmax(wl[:, -1, :], -1)[:, None]
        ttok, tcaches = serve(tp, tcaches, ttok, s + i)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert tref.attention_ref.calls == calls


# ---------------------------------------------------------------------------
# loss, init, count, entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_seq2seq_loss_and_its_gradient_match_reference(weighted):
    """The loss (with per-sample weights or without) and its gradient
    through the whole model, leaf by leaf, the plain attention under
    autograd."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg, seed=1)
    frames = _rand((4, 23, jcfg.d_model), 15)
    toks = _tokens((4, 18), jcfg.vocab_size, 16)
    w = np.array([0.0, 1.5, 2.0, 0.5], np.float32) if weighted else None
    jloss, jgrad = jax.value_and_grad(jencdec.seq2seq_loss)(
        jp, jnp.asarray(frames), jnp.asarray(toks), jcfg,
        sample_weights=None if w is None else jnp.asarray(w))
    view, leaves = trainable(tp)
    loss = tbuild(tcfg, CPU).loss(
        view, (torch.from_numpy(frames), torch.from_numpy(toks)),
        None if w is None else torch.from_numpy(w))
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    want = encdec_params_from_jax(
        tcfg, jax.tree.map(np.asarray, jgrad)).state_dict()
    assert sorted(grads) == sorted(want)
    for name, g in want.items():
        np.testing.assert_allclose(_np(grads[name]), _np(g), **TOL,
                                   err_msg=name)


def test_init_draws_the_reference_laws():
    """``bundle.init`` draws other numbers than JAX's threefry stream, but
    the same tree of shapes and dtypes and the same laws: per leaf, the
    spread of the reference's draw to 10 %, on leaves of >= 4096 values;
    the norms' ones exactly."""
    jcfg, tcfg = _cfgs()
    jp = jax.tree.map(np.asarray, jbuild(jcfg, tp=1, dp=1).init(
        jax.random.PRNGKey(0)))
    want = encdec_params_from_jax(tcfg, jp).state_dict()
    got = tbuild(tcfg, CPU).init(0).state_dict()
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == w.dtype == torch.float32
        if w.numel() >= 4096:
            np.testing.assert_allclose(float(g.std()), float(w.std()),
                                       rtol=0.1, err_msg=name)
        else:
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_encdec_params_from_jax_keeps_def_dtypes_and_refuses_a_mismatch():
    jcfg, tcfg = _cfgs()
    jp = jax.tree.map(np.asarray, jbuild(jcfg, tp=1, dp=1).init(
        jax.random.PRNGKey(0)))
    bf = tcfg.replace(param_dtype=torch.bfloat16)
    assert {p.dtype for p in encdec_params_from_jax(bf, jp).parameters()} \
        == {torch.bfloat16}
    with pytest.raises(ValueError, match="entries"):
        encdec_params_from_jax(tcfg.replace(n_layers=3), jp)


def test_param_count_at_full_width():
    """seamless-m4t-medium: 12 encoder and 12 decoder layers, d 1024,
    vocab padded to 256,256."""
    cfg = tconfigs.get_config(ARCH)
    assert cfg.padded_vocab == 256_256 and cfg.is_enc_dec
    assert tree_param_count(tencdec.encdec_defs(cfg)) == 877_197_312
    assert jbuild(jconfigs.get_config(ARCH), tp=1, dp=1).num_params \
        == 877_197_312
    assert tbuild(cfg, CPU).num_params == 877_197_312


def test_serve_entry_point_on_the_cpu(capsys):
    res = tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "11",
                       "--decode-tokens", "4"])
    out = capsys.readouterr().out
    assert f"arch={ARCH}" in out and "prefill:" in out
    assert res.frames.shape == (2, 11, res.cfg.d_model)
    assert res.frames.dtype == torch.float32
    assert res.inputs[1] is res.prompts and res.tokens.shape == (2, 4)
    assert res.logits.shape == (2, 11, res.cfg.padded_vocab)
    assert bool(torch.isfinite(res.logits).all())
    assert 0 <= int(res.tokens.min()) \
        and int(res.tokens.max()) < res.cfg.padded_vocab
    assert res.stats["k3_launches_per_prefill"] == 0
    assert tserve.kernel_libraries(res.cfg) == ["flash_attention"]


def test_train_entry_point_refuses_the_encoder_decoder():
    """The token_stream batches carry no frames, as the reference's do
    not (its CLI cannot train it either); the encoder-decoder trains
    through the train step on (frames, tokens)."""
    with pytest.raises(NotImplementedError,
                       match="carry no frames.*make_train_step"):
        ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
