"""The port's decoder serve slice on the CPU against the reference: the
dense GQA decoders and Mamba-2.

Module by module (RMSNorm, RoPE, the MLPs, the KV-cache writes, GQA
prefill and decode, the Mamba-2 mixer's prefill and recurrent decode, the
decoder forward, a GQA + SSD hybrid), then the whole slice: the port's
bundle and serve step against
``repro.models.registry.build_bundle(cfg.smoke(), tp=1, dp=1)`` on the
reference's own ``PRNGKey(0)`` weights, carried across with
``lm_params_from_jax``, and the same numpy prompts of a ragged length
(37): the prefill logits, then 8 greedy decode steps, their tokens and
logits.  Nineteen smoke variants: qwen1.5-0.5b (QKV bias), qwen3-1.7b
(qk-norm, GQA G = 2), qwen1.5-0.5b's sliding-window variant with a
16-slot ring cache, shorter than the prompt, the three dense archs ported
by config alone (granite-8b, qwen2.5-14b with QKV bias, chameleon-34b
with qk-norm), mamba2-1.3b three ways:
as it is (the prompt of 37 ragged against its chunk of 32, so the
reference pads), with two SSD groups, and with a chunk of 64, longer than
the prompt (one chunk of S), and recurrentgemma-9b four ways: its smoke
config (two RG-LRU layers), four layers (rglru, rglru, local under the
reference's scan, then an rglru tail layer), the same at its full
head_dim of 256, and at head_dim 256 with a 16-slot ring cache for the
local layer, shorter than the prompt, and mixtral-8x22b four ways: its
smoke config (two sliding-window MoE layers, 4 experts, top 2), with a
16-slot ring cache, shorter than the prompt, with ``capacity_factor=0.5``
(the prefill drops assignments; a decode step's capacity of 4 never
does), and with 3 layers, a dense lead layer (``moe_first_dense=1``) and
a shared expert, and deepseek-v3-671b two ways: its smoke config (a dense
lead layer and an MoE layer, 4 experts, top 2, a shared expert; MLA with
the q bottleneck, whose prefill is the expanded form through K3's plain
version at q.k width 48, v width 32, and whose decode is the absorbed
form against the latent cache; the MTP head, which serving never runs)
and without the q bottleneck (``q_lora_rank=0``).  Beside them, a
decoder-only model
of frame inputs (embeddings in, no embedding table) and one with a
bidirectional ``enc_attn`` layer, against the reference's.

The reference initializes biases to 0, norm weights and the SSD's skip to
1, and its log-decays and dt biases to 0 (every head then decays alike);
the tests perturb those leaves with seeded noise, the same on both sides,
so that the bias, norm and per-head paths are held too.

Tolerance: float32 smoke configs, rtol 1e-4 / atol 1e-5 -- the same f32
math through 2 layers, with matmul and reduction sums taken in another
order by XLA and PyTorch (the observed gap is ~6e-6 on logits of ~4);
greedy tokens must be equal.  The full-width parameter counts of
the archs equal the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models import transformer as jtfm
from repro.models.param import init_params as jinit
from repro.models.registry import build_bundle as jbuild
from repro_torch import configs as tconfigs
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttfm
from repro_torch.models.param import (ParamTree, lm_params_from_jax,
                                      tree_param_count)
from repro_torch.models.registry import build_bundle as tbuild

TOL = dict(rtol=1e-4, atol=1e-5)
CPU = torch.device("cpu")
# (arch, its long-context variant (sliding window), smoke overrides)
GQA_VARIANTS = {
    "qwen1.5-0.5b": ("qwen1.5-0.5b", False, {}),
    "qwen3-1.7b": ("qwen3-1.7b", False, {}),
    "qwen1.5-0.5b-swa16": ("qwen1.5-0.5b", True, dict(window=16)),
    "granite-8b": ("granite-8b", False, {}),
    "qwen2.5-14b": ("qwen2.5-14b", False, {}),
    "chameleon-34b": ("chameleon-34b", False, {}),
}
SSD_VARIANTS = {
    "mamba2-1.3b": ("mamba2-1.3b", False, {}),
    "mamba2-1.3b-g2": ("mamba2-1.3b", False, dict(ssm_ngroups=2)),
    "mamba2-1.3b-chunk64": ("mamba2-1.3b", False, dict(ssm_chunk=64)),
}
RGLRU_VARIANTS = {
    "recurrentgemma-9b": ("recurrentgemma-9b", False, {}),
    "recurrentgemma-9b-l4": ("recurrentgemma-9b", False, dict(n_layers=4)),
    "recurrentgemma-9b-dh256": ("recurrentgemma-9b", False,
                                dict(n_layers=4, head_dim=256)),
    "recurrentgemma-9b-dh256-window16": (
        "recurrentgemma-9b", False, dict(n_layers=4, head_dim=256,
                                         window=16)),
}
MOE_VARIANTS = {
    "mixtral-8x22b": ("mixtral-8x22b", False, {}),
    "mixtral-8x22b-window16": ("mixtral-8x22b", False, dict(window=16)),
    "mixtral-8x22b-cf05": ("mixtral-8x22b", False,
                           dict(capacity_factor=0.5)),
    "mixtral-8x22b-shared-lead": ("mixtral-8x22b", False,
                                  dict(n_layers=3, moe_first_dense=1,
                                       moe_shared_experts=1)),
}
MLA_VARIANTS = {
    "deepseek-v3-671b": ("deepseek-v3-671b", False, {}),
    "deepseek-v3-671b-no-q-lora": ("deepseek-v3-671b", False,
                                   dict(q_lora_rank=0)),
}
VARIANTS = {**GQA_VARIANTS, **SSD_VARIANTS, **RGLRU_VARIANTS, **MOE_VARIANTS,
            **MLA_VARIANTS}


def _cfgs(variant):
    arch, long, kw = VARIANTS[variant]
    jcfg = (jconfigs.long_context_config if long else jconfigs.get_config)(arch)
    tcfg = (tconfigs.long_context_config if long else tconfigs.get_config)(arch)
    return jcfg.smoke(**kw), tcfg.smoke(**kw)


def _perturb(tree, seed=0):
    """Seeded noise on the leaves the reference inits to 0 or 1 (biases,
    norm weights, the SSD's log-decay, dt bias and skip), as numpy; other
    leaves unchanged."""
    rng = np.random.default_rng(seed)

    def one(path, a):
        a = np.asarray(a, np.float32)
        name = jax.tree_util.keystr(path)
        if any(t in name for t in ("'b'", "bkv", "ln", "norm", "a_log",
                                   "dt_bias", "d_skip", "conv_b")):
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


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rmsnorm_matches_reference():
    x, w = _rand((2, 5, 64), 0), 1 + 0.1 * _rand((64,), 1)
    got = tlayers.rmsnorm(torch.from_numpy(w), torch.from_numpy(x), 1e-5)
    want = jlayers.rmsnorm(jnp.asarray(w), jnp.asarray(x), 1e-5)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("offset", [0, 1000])
@pytest.mark.parametrize("dh", [64, 128])
def test_rope_matches_reference(dh, offset):
    x = _rand((2, 7, 4, dh), 2)
    pos = offset + np.arange(7)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("ffn", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_reference(ffn):
    jcfg, tcfg = (c.replace(ffn_kind=ffn) for c in _cfgs("qwen1.5-0.5b"))
    jp = _perturb(jinit(jlayers.mlp_def(jcfg, tp=1), jax.random.PRNGKey(1)))
    x = _rand((2, 9, jcfg.d_model), 3)
    got = tlayers.mlp(_torch_tree(jp), torch.from_numpy(x), tcfg)
    want = jlayers.mlp(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_param_count_at_full_width():
    """qwen1.5-0.5b: 24 layers, d 1024, vocab padded to 152,064."""
    cfg = tconfigs.get_config("qwen1.5-0.5b")
    assert cfg.padded_vocab == 152_064
    assert tree_param_count(ttfm.model_defs(cfg)) == 619_832_320
    jcfg = jconfigs.get_config("qwen1.5-0.5b")
    assert jbuild(jcfg, tp=1, dp=1).num_params == 619_832_320


@pytest.mark.parametrize("arch,n_params", [
    ("granite-8b", 8_254_689_280), ("qwen2.5-14b", 14_770_033_664),
    ("chameleon-34b", 34_293_436_416)])
def test_dense_archs_param_count_at_full_width(arch, n_params):
    """The archs ported by config alone: the port's full-width defs count
    the reference bundle's parameters."""
    cfg = tconfigs.get_config(arch)
    assert tree_param_count(ttfm.model_defs(cfg)) == n_params
    assert jbuild(jconfigs.get_config(arch), tp=1, dp=1).num_params \
        == n_params
    assert tbuild(cfg, CPU).num_params == n_params


def test_recurrentgemma_param_count_at_full_width():
    """recurrentgemma-9b: 26 RG-LRU and 12 local-attention layers (12 units
    of rglru, rglru, local and an rglru tail of 2), d 4096, vocab 256,000."""
    cfg = tconfigs.get_config("recurrentgemma-9b")
    kinds = [kind for kind, _ in ttfm.layer_sigs(cfg)]
    assert kinds.count("rglru") == 26 and kinds.count("local") == 12
    assert tree_param_count(ttfm.model_defs(cfg)) == 10_444_984_320
    assert jbuild(jconfigs.get_config("recurrentgemma-9b"), tp=1,
                  dp=1).num_params == 10_444_984_320
    assert tbuild(cfg, CPU).num_params == 10_444_984_320


def test_mixtral_param_count_at_full_width():
    """mixtral-8x22b: 56 sliding-window MoE layers (8 experts of width
    16,384, the router in float32), d 6144, untied embed and unembed over
    32,768: ~140.6B parameters, the reference's count."""
    cfg = tconfigs.get_config("mixtral-8x22b")
    assert ttfm.layer_sigs(cfg) == [("swa", "moe")] * 56
    assert tree_param_count(ttfm.model_defs(cfg)) == 140_630_071_296
    assert jbuild(jconfigs.get_config("mixtral-8x22b"), tp=1,
                  dp=1).num_params == 140_630_071_296
    assert tbuild(cfg, CPU).num_params == 140_630_071_296
    assert tbuild(cfg.replace(n_layers=12), CPU).num_params \
        == 30_451_390_464


def test_init_draws_the_reference_laws():
    """``bundle.init`` draws other numbers than JAX's threefry stream, but
    the same tree of shapes and dtypes and the same laws: per leaf, the
    spread of the reference's draw (1/sqrt(fan_in), 1/sqrt(d_model) for the
    embedding, zeros, ones) to 10 %, on leaves of >= 4096 values."""
    jcfg, tcfg = _cfgs("qwen3-1.7b")
    jp = jax.tree.map(np.asarray, jbuild(jcfg, tp=1, dp=1).init(
        jax.random.PRNGKey(0)))
    want = lm_params_from_jax(tcfg, jp).state_dict()
    got = tbuild(tcfg, CPU).init(0).state_dict()
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == w.dtype == torch.float32
        if w.numel() >= 4096:
            np.testing.assert_allclose(float(g.std()), float(w.std()),
                                       rtol=0.1, err_msg=name)
        else:       # zeros and ones
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_unported_archs_raise_naming_roadmap():
    """An arch the port has no config of raises naming ROADMAP.md, and so
    does an attention kind it has not ported (MLA and MTP are ported: a
    GQA model takes an MTP head, as the reference's does)."""
    for arch in jconfigs.ARCH_IDS:
        if arch not in tconfigs.ARCH_IDS:
            with pytest.raises(ValueError, match="ROADMAP"):
                tconfigs.get_config(arch)
    assert set(tconfigs.ARCH_IDS) <= set(jconfigs.ARCH_IDS)
    cfg = tconfigs.get_config("qwen3-1.7b").smoke(attn_kind="linear")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tbuild(cfg, CPU)
    for kw in (dict(attn_kind="mla"), dict(mtp_depth=1)):
        tbuild(tconfigs.get_config("qwen3-1.7b").smoke(**kw), CPU)


def test_enc_attn_layer_in_a_decoder_matches_reference():
    """A decoder-only model with a bidirectional ``enc_attn`` layer builds
    and prefills without caches as the reference's does (K3's plain
    version, non-causal, for that layer); neither keeps a cache for it."""
    jcfg, tcfg = (c.replace(block_pattern=("attn", "enc_attn"))
                  for c in _cfgs("qwen3-1.7b"))
    jp = _jparams(jcfg)
    tp = lm_params_from_jax(tcfg, jp)
    toks = np.random.default_rng(12).integers(0, jcfg.vocab_size, (2, 17))
    want, _, _ = jtfm.forward(jp, jnp.asarray(toks), jcfg)
    got, _ = ttfm.forward(tp, torch.from_numpy(toks), tcfg)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    with pytest.raises(ValueError):
        jtfm.init_caches(jcfg, 2, 20)
    with pytest.raises(ValueError, match="enc_attn"):
        tbuild(tcfg, CPU).init_caches(2, 20)


def test_frames_decoder_serve_slice_matches_reference_bundle():
    """``input_mode="frames"`` in a decoder-only model: no embedding table;
    the prefill and 8 decode steps take embeddings [B, S, D] (cast to the
    compute dtype) against the reference bundle, logits at TOL.
    ``launch.serve`` refuses such a model: it has no token loop to feed."""
    jcfg, tcfg = (c.replace(input_mode="frames")
                  for c in _cfgs("qwen3-1.7b"))
    jb, tb = jbuild(jcfg, tp=1, dp=1), tbuild(tcfg, CPU)
    assert tb.num_params == jb.num_params \
        == jbuild(jcfg.replace(input_mode="tokens"), tp=1, dp=1).num_params \
        - jcfg.padded_vocab * jcfg.d_model
    jp = _jparams(jcfg)
    assert "embed" not in jp
    tp = lm_params_from_jax(tcfg, jp)
    b, s, steps = 2, 23, 8
    x = _rand((b, s + steps, jcfg.d_model), 13)
    jcache, tcache = jb.init_caches(b, s + steps), tb.init_caches(b, s + steps)
    want, jcache = jax.jit(jb.prefill)(jp, jnp.asarray(x[:, :s]), jcache)
    got, tcache = tb.prefill(tp, torch.from_numpy(x[:, :s]), tcache)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    jdecode = jax.jit(jb.decode)
    for i in range(steps):
        xs = x[:, s + i:s + i + 1]
        want, jcache = jdecode(jp, jcache, jnp.asarray(xs), jnp.asarray(s + i))
        got, tcache = tb.decode(tp, tcache, torch.from_numpy(xs), s + i)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    with pytest.raises(ValueError, match="frames"):
        tserve.run(tcfg, batch=1, prompt_len=4, decode_tokens=2, device=CPU)


# ---------------------------------------------------------------------------
# KV cache writes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    ("linear", 10, 4, 3, False),        # prefill segment at pos 3
    ("linear decode", 10, 1, 9, False),  # the last slot
    ("ring decode", 8, 1, 13, True),    # slot 13 mod 8
    ("ring prefill", 8, 11, 0, True),   # keep the trailing 8 entries
    ("ring prefill at pos", 8, 8, 5, True),
], ids=lambda c: c[0])
def test_cache_write_matches_reference(case):
    _, cap, s, pos, ring = case
    cache = {"k": _rand((2, cap, 2, 8), 4), "v": _rand((2, cap, 2, 8), 5)}
    k_new, v_new = _rand((2, s, 2, 8), 6), _rand((2, s, 2, 8), 7)
    want = jattn._cache_write({n: jnp.asarray(a) for n, a in cache.items()},
                              jnp.asarray(k_new), jnp.asarray(v_new),
                              jnp.asarray(pos), ring)
    tcache = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    got = tattn._cache_write(tcache, torch.from_numpy(k_new),
                             torch.from_numpy(v_new), pos, ring)
    assert got is tcache                       # in place
    for n in ("k", "v"):
        np.testing.assert_array_equal(_np(got[n]), _np(want[n]))


def test_cache_write_past_the_end_raises():
    cache = {"k": torch.zeros(1, 4, 1, 8), "v": torch.zeros(1, 4, 1, 8)}
    with pytest.raises(ValueError):
        tattn._cache_write(cache, torch.ones(1, 2, 1, 8),
                           torch.ones(1, 2, 1, 8), 3, ring=False)


# ---------------------------------------------------------------------------
# GQA prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", list(GQA_VARIANTS))
def test_gqa_apply_prefill_and_decode_match_reference(variant):
    jcfg, tcfg = _cfgs(variant)
    kind = jcfg.block_pattern[0]
    jp = _perturb(jinit(jattn.gqa_def(jcfg, tp=1), jax.random.PRNGKey(2)))
    tp = _torch_tree(jp)
    s, steps, max_len = 21, 3, 40
    x = _rand((2, s + steps, jcfg.d_model), 8)
    jcache = jattn.init_kv_cache(jcfg, 2, max_len, kind)
    tcache = tattn.init_kv_cache(tcfg, 2, max_len, kind, CPU)
    assert tcache["k"].shape == jcache["k"].shape

    calls = tref.attention_ref.calls
    want, jcache = jattn.gqa_apply(jp, jnp.asarray(x[:, :s]), jcfg, kind=kind,
                                   cache=jcache)
    got, tcache = tattn.gqa_apply(tp, torch.from_numpy(x[:, :s]), tcfg,
                                  kind=kind, cache=tcache)
    assert tref.attention_ref.calls == calls + 1   # K3's plain version
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for i in range(steps):
        xs = x[:, s + i:s + i + 1]
        want, jcache = jattn.gqa_apply(jp, jnp.asarray(xs), jcfg, kind=kind,
                                       pos_offset=s + i, cache=jcache,
                                       decode=True)
        got, tcache = tattn.gqa_apply(tp, torch.from_numpy(xs), tcfg,
                                      kind=kind, pos_offset=s + i,
                                      cache=tcache, decode=True)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        for n in ("k", "v"):
            np.testing.assert_allclose(_np(tcache[n]), _np(jcache[n]), **TOL)
    assert tref.attention_ref.calls == calls + 1   # decode stays plain torch


def test_gqa_prefill_at_an_offset_matches_reference():
    jcfg, tcfg = _cfgs("qwen1.5-0.5b-swa16")
    jp = _perturb(jinit(jattn.gqa_def(jcfg, tp=1), jax.random.PRNGKey(3)))
    x = _rand((1, 24, jcfg.d_model), 9)
    want, _ = jattn.gqa_apply(jp, jnp.asarray(x), jcfg, kind="swa",
                              pos_offset=50)
    got, _ = tattn.gqa_apply(_torch_tree(jp), torch.from_numpy(x), tcfg,
                             kind="swa", pos_offset=50)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


# ---------------------------------------------------------------------------
# decoder forward and the whole slice
# ---------------------------------------------------------------------------

def _jparams(jcfg, seed=0):
    return _perturb(jbuild(jcfg, tp=1, dp=1).init(jax.random.PRNGKey(seed)))


def test_layer_plan_and_forward_match_reference():
    jcfg, tcfg = _cfgs("qwen3-1.7b")
    jcfg, tcfg = jcfg.replace(n_layers=3), tcfg.replace(n_layers=3)
    lead, unit, n_rep, tail = jtfm.layer_plan(jcfg)
    assert ttfm.layer_sigs(tcfg) == list(lead) + list(unit) * n_rep \
        + list(tail)
    jp = _jparams(jcfg)
    tp = lm_params_from_jax(tcfg, jp)
    assert len(tp["layers"]) == 3
    toks = np.random.default_rng(10).integers(0, jcfg.vocab_size, (2, 19))
    want, _, _ = jtfm.forward(jp, jnp.asarray(toks), jcfg)
    got, _ = ttfm.forward(tp, torch.from_numpy(toks), tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 19,
                                                        tcfg.padded_vocab)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_serve_slice_matches_reference_bundle(variant):
    jcfg, tcfg = _cfgs(variant)
    jb = jbuild(jcfg, tp=1, dp=1)
    tb = tbuild(tcfg, CPU)
    assert tb.num_params == jb.num_params
    jp = _jparams(jcfg)
    tp = lm_params_from_jax(tcfg, jp)
    b, s, steps = 2, 37, 8
    prompts = np.random.default_rng(11).integers(0, jcfg.vocab_size, (b, s))
    jcache, tcache = jb.init_caches(b, s + steps), tb.init_caches(b, s + steps)

    kinds = [kind for kind, _ in ttfm.layer_sigs(tcfg)]
    launches = (flash_attention.launches, ssd_scan.launches)
    calls = (tref.attention_ref.calls, tref.ssd_chunked.calls)
    want, jcache = jax.jit(jb.prefill)(jp, jnp.asarray(prompts, jnp.int32),
                                       jcache)
    got, tcache = tsteps.make_prefill_step(tb)(tp, torch.from_numpy(prompts),
                                               tcache)
    # CPU: the plain versions, once per layer of their kind
    assert (flash_attention.launches, ssd_scan.launches) == launches
    assert tref.attention_ref.calls == calls[0] + kinds.count("attn") \
        + kinds.count("swa") + kinds.count("local")
    assert tref.ssd_chunked.calls == calls[1] + kinds.count("ssd")
    np.testing.assert_allclose(_np(got), _np(want), **TOL)

    jdecode, serve = jax.jit(jb.decode), tsteps.make_serve_step(tb)
    jtok = jnp.argmax(want[:, -1:], -1)
    ttok = torch.argmax(got[:, -1:], -1)
    for i in range(steps):
        wl, jcache = jdecode(jp, jcache, jtok, jnp.asarray(s + i))
        gl, _ = tb.decode(tp, [{n: c.clone() for n, c in lc.items()}
                               for lc in tcache], ttok, s + i)
        np.testing.assert_allclose(_np(gl), _np(wl), **TOL)
        jtok = jnp.argmax(wl[:, -1, :], -1)[:, None]
        ttok, tcache = serve(tp, tcache, ttok, s + i)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


def test_serve_entry_point_on_the_cpu(capsys):
    res = tserve.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "33",
                       "--decode-tokens", "4"])
    out = capsys.readouterr().out
    assert "arch=qwen3-1.7b" in out and "prefill:" in out
    assert res.tokens.shape == (2, 4)
    assert res.logits.shape == (2, 33, res.cfg.padded_vocab)
    assert bool(torch.isfinite(res.logits).all())
    assert int(res.tokens.min()) >= 0 \
        and int(res.tokens.max()) < res.cfg.padded_vocab
    assert res.stats["k3_launches_per_prefill"] == 0
    assert res.stats["card"] is None


def test_serve_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(["--smoke"])


# ---------------------------------------------------------------------------
# Mamba-2: the mixer, its parameters, the hybrid, the serve entry point
# ---------------------------------------------------------------------------

def test_mamba2_param_count_at_full_width():
    """mamba2-1.3b: 48 layers, d 2048, vocab padded to 50,432, tied."""
    cfg = tconfigs.get_config("mamba2-1.3b")
    assert cfg.padded_vocab == 50_432
    assert tree_param_count(ttfm.model_defs(cfg)) == 1_344_052_224
    jcfg = jconfigs.get_config("mamba2-1.3b")
    assert jbuild(jcfg, tp=1, dp=1).num_params == 1_344_052_224


@pytest.mark.parametrize("variant", list(SSD_VARIANTS))
def test_ssd_apply_prefill_and_decode_match_reference(variant):
    """A ragged prefill (37 rows) from the zero state, then 3 recurrent
    decode steps: outputs and both parts of the state."""
    jcfg, tcfg = _cfgs(variant)
    jp = _perturb(jinit(jssm.ssd_def(jcfg, tp=1), jax.random.PRNGKey(4)))
    tp = _torch_tree(jp)
    s, steps = 37, 3
    x = _rand((2, s + steps, jcfg.d_model), 12)
    jstate = jssm.init_ssd_state(jcfg, 2)
    tstate = tssm.init_ssd_state(tcfg, 2, CPU)
    for n in ("ssm", "conv"):
        assert tstate[n].shape == jstate[n].shape

    calls = tref.ssd_chunked.calls
    want, jstate = jssm.ssd_apply(jp, jnp.asarray(x[:, :s]), jcfg,
                                  state=jstate)
    got, out_state = tssm.ssd_apply(tp, torch.from_numpy(x[:, :s]), tcfg,
                                    state=tstate)
    assert out_state is tstate                     # in place
    assert tref.ssd_chunked.calls == calls + 1     # K4's plain version
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for i in range(steps):
        for n in ("ssm", "conv"):
            np.testing.assert_allclose(_np(tstate[n]), _np(jstate[n]), **TOL)
        xs = x[:, s + i:s + i + 1]
        want, jstate = jssm.ssd_apply(jp, jnp.asarray(xs), jcfg,
                                      state=jstate, decode=True)
        got, _ = tssm.ssd_apply(tp, torch.from_numpy(xs), tcfg,
                                state=tstate, decode=True)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    assert tref.ssd_chunked.calls == calls + 1     # decode stays plain torch


def test_ssd_prefill_shorter_than_the_conv_window_raises():
    _, tcfg = _cfgs("mamba2-1.3b")
    p = tbuild(tcfg, CPU).init(0)["layers"][0]["mixer"]
    state = tssm.init_ssd_state(tcfg, 1, CPU)
    with pytest.raises(ValueError, match="conv window"):
        tssm.ssd_apply(p, torch.zeros(1, tcfg.ssm_conv - 2, tcfg.d_model),
                       tcfg, state=state)


def test_attn_ssd_hybrid_matches_reference():
    """block_pattern ("attn", "ssd") on qwen3's smoke, as a hybrid family
    (the smoke's SSD widths): both mixers with a dense FFN each, a KV cache
    and a recurrent state; the layer plan, the prefill logits and 3 decode
    steps against the reference bundle."""
    kw = dict(arch_type="hybrid", block_pattern=("attn", "ssd"))
    jcfg = jconfigs.get_config("qwen3-1.7b").replace(**kw).smoke(n_layers=4)
    tcfg = tconfigs.get_config("qwen3-1.7b").replace(**kw).smoke(n_layers=4)
    assert tcfg.ssm_state == jcfg.ssm_state == 32
    lead, unit, n_rep, tail = jtfm.layer_plan(jcfg)
    sigs = list(lead) + list(unit) * n_rep + list(tail)
    assert ttfm.layer_sigs(tcfg) == sigs == [("attn", "dense"),
                                             ("ssd", "dense")] * 2
    jb, tb = jbuild(jcfg, tp=1, dp=1), tbuild(tcfg, CPU)
    assert tb.num_params == jb.num_params
    jp = _jparams(jcfg)
    tp = lm_params_from_jax(tcfg, jp)
    b, s, steps = 2, 19, 3
    prompts = np.random.default_rng(13).integers(0, jcfg.vocab_size, (b, s))
    jcache, tcache = jb.init_caches(b, s + steps), tb.init_caches(b, s + steps)
    want, jcache = jax.jit(jb.prefill)(jp, jnp.asarray(prompts, jnp.int32),
                                       jcache)
    got, tcache = tb.prefill(tp, torch.from_numpy(prompts), tcache)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    tok = np.array(jnp.argmax(want[:, -1:], -1))
    jdecode = jax.jit(jb.decode)
    for i in range(steps):
        want, jcache = jdecode(jp, jcache, jnp.asarray(tok),
                               jnp.asarray(s + i))
        got, tcache = tb.decode(tp, tcache, torch.from_numpy(tok), s + i)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        tok = np.array(jnp.argmax(want[:, -1:], -1))


def test_lm_params_from_jax_keeps_each_leaf_in_its_def_dtype():
    """A bf16 mamba2 smoke config: the SSD's a_log, dt_bias and d_skip come
    across as float32, as the reference keeps them, the rest as bf16."""
    kw = dict(param_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16)
    jcfg = jconfigs.get_config("mamba2-1.3b").smoke(**kw)
    tcfg = tconfigs.get_config("mamba2-1.3b").smoke(
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    jp = jbuild(jcfg, tp=1, dp=1).init(jax.random.PRNGKey(0))
    got = lm_params_from_jax(tcfg, jax.tree.map(
        lambda a: np.asarray(a, np.float32), jp)).state_dict()
    f32 = ("a_log", "dt_bias", "d_skip")
    for name, t in got.items():
        want = torch.float32 if name.split(".")[-1] in f32 else torch.bfloat16
        assert t.dtype == want, name
    assert sum(name.split(".")[-1] in f32 for name in got) \
        == 3 * tcfg.n_layers
    # the port's own init draws the same dtypes
    init = tbuild(tcfg, CPU).init(0).state_dict()
    assert {k: v.dtype for k, v in init.items()} \
        == {k: v.dtype for k, v in got.items()}


def test_lm_params_from_jax_keeps_lam_in_float32():
    """A bf16 recurrentgemma smoke config: each RG-LRU layer's lam comes
    across as float32, as the reference keeps it, the rest as bf16."""
    kw = dict(param_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16,
              n_layers=4)
    jcfg = jconfigs.get_config("recurrentgemma-9b").smoke(**kw)
    tcfg = tconfigs.get_config("recurrentgemma-9b").smoke(
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, n_layers=4)
    jp = jbuild(jcfg, tp=1, dp=1).init(jax.random.PRNGKey(0))
    got = lm_params_from_jax(tcfg, jax.tree.map(
        lambda a: np.asarray(a, np.float32), jp)).state_dict()
    for name, t in got.items():
        want = torch.float32 if name.endswith(".lam") else torch.bfloat16
        assert t.dtype == want, name
    assert sum(name.endswith(".lam") for name in got) == 3
    init = tbuild(tcfg, CPU).init(0).state_dict()
    assert {k: v.dtype for k, v in init.items()} \
        == {k: v.dtype for k, v in got.items()}


def test_serve_entry_point_recurrentgemma_on_the_cpu(capsys):
    res = tserve.main(["--arch", "recurrentgemma-9b", "--smoke", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "9",
                       "--decode-tokens", "4"])
    out = capsys.readouterr().out
    assert "arch=recurrentgemma-9b" in out and "prefill:" in out
    assert res.tokens.shape == (2, 4)
    assert res.logits.shape == (2, 9, res.cfg.padded_vocab)
    assert bool(torch.isfinite(res.logits).all())
    assert int(res.tokens.min()) >= 0 \
        and int(res.tokens.max()) < res.cfg.padded_vocab
    assert res.stats["k3_launches_per_prefill"] == 0
    assert tserve.kernel_libraries(
        res.cfg.replace(n_layers=3)) == ["flash_attention"]


def test_serve_entry_point_mamba2_on_the_cpu(capsys):
    res = tserve.main(["--arch", "mamba2-1.3b", "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "37",
                       "--decode-tokens", "4"])
    out = capsys.readouterr().out
    assert "arch=mamba2-1.3b" in out and "prefill:" in out
    assert res.tokens.shape == (2, 4)
    assert res.logits.shape == (2, 37, res.cfg.padded_vocab)
    assert bool(torch.isfinite(res.logits).all())
    assert int(res.tokens.min()) >= 0 \
        and int(res.tokens.max()) < res.cfg.padded_vocab
    assert res.stats["k3_launches_per_prefill"] == 0
    assert res.stats["k4_launches_per_prefill"] == 0
    assert tserve.kernel_libraries(res.cfg) == ["ssd_scan"]
