"""The blocked form of K3's plain version on the CPU against the reference,
and the long-sequence train path it opens.

``kernels.ref.grouped_attention_blocked`` is the reference's online
softmax over 1,024-key blocks (``repro.models.attention.grouped_attention``
past Sq·Sk = 2048²), as a ``torch.autograd.Function`` whose backward
recomputes each block.  ``attention_ref`` (K3's plain version, which the
train path differentiates) takes it past that size.  Held here, on
numpy-seeded inputs, at S 2,100 (a ragged last block) and S 4,096 (whole
blocks):

- the forward against the reference's blocked form, causal, with windows
  of 300 and 1,500 across the block edges, G 1 and G 4, q.k width 48 with
  v width 32, in f32 and bf16; the gradients against ``jax.grad`` of the
  same reference call;
- non-causal: at S 4,096 equal to the reference's blocked form; at S
  2,100 the port's one departure.  The reference gives its padded keys
  the position max(qpos) + 1, which only a causal mask removes, so its
  non-causal blocked form lets zero keys into every row's softmax; the
  port masks them and equals the reference's direct form
  (``ANALYSIS_DIRECT_ATTENTION``, set for the test alone), and a second
  test shows that the reference's two forms disagree there;
- the threshold: at S 2,048 the plain path is bitwise the direct form; at
  2,049 it is the blocked form;
- no tensor saved for backward has an Sq x Sk extent;
- ``lm_loss`` and its gradient past 2048² at smoke width for GQA, swa,
  RG-LRU with a local layer and MLA with MTP; ``seq2seq_loss`` with 2,100
  frames against the reference's direct form; ``launch.train`` end to end
  at 2,100 tokens;
- the input shapes of ``configs.shapes`` and the registry's
  ``long_context_ok`` / ``supported_shapes``.

Tolerances: f32 outputs at 2e-5 (``test_torch_attention.py``'s F32_TOL);
bf16 outputs compared in f32 at 6e-2; gradients at rtol 1e-5 plus 1e-5 of
their largest magnitude (``test_torch_train.py``'s); the losses at rtol
1e-5 / atol 1e-6 and the model's gradients at rtol 1e-4 / atol 1e-6
(``test_torch_train.py`` and ``test_torch_mla.py``); the encoder-decoder's
loss and gradients at rtol 1e-4 / atol 1e-5 (``test_torch_encdec.py``'s).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import checkpoint as jckpt
from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro.models import transformer as jtfm
from repro.models.registry import build_bundle as jbuild
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import train as ttrain
from repro_torch.models import encdec as tencdec
from repro_torch.models import transformer as ttfm
from repro_torch.models.param import (encdec_params_from_jax,
                                      lm_params_from_jax,
                                      lm_params_to_stacked, map_named,
                                      trainable)

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=6e-2, atol=6e-2)
GRAD_RTOL, GRAD_ATOL_SHARE = 1e-5, 1e-5
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
ENCDEC_TOL = dict(rtol=1e-4, atol=1e-5)
DTYPES = {"f32": (torch.float32, jnp.float32, F32_TOL),
          "bf16": (torch.bfloat16, jnp.bfloat16, BF16_TOL)}
# (H, KH, q.k width, v width, window): G 1 causal; G 4 with a window of
# 300; q.k 48 over v 32 with a window of 1,500
CASES = {"g1": (2, 2, 16, 16, None), "g4_window300": (4, 1, 16, 16, 300),
         "dqk48_dv32_window1500": (4, 2, 48, 32, 1500)}
LENGTHS = (2100, 4096)


def _inputs(s, h, kh, dqk, dv, dtype="f32", seed=0, sk=None):
    """q, k, v (and a cotangent of the output) as torch tensors in
    ``dtype`` and the same values in JAX."""
    tdt, jdt, _ = DTYPES[dtype]
    sk = sk or s
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((1, s, h, dqk), (1, sk, kh, dqk), (1, sk, kh, dv),
                          (1, s, h, dv))]
    ts = [torch.from_numpy(a).to(tdt) for a in arrs]
    js = [jnp.asarray(t.float().numpy()).astype(jdt) for t in ts]
    return ts, js


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _reference(js, causal, window):
    pos_q, pos_k = jnp.arange(js[0].shape[1]), jnp.arange(js[1].shape[1])
    return jattn.grouped_attention(*js[:3], pos_q, pos_k, causal=causal,
                                   window=window)


def _port(ts, causal, window):
    """The K3 wrapper on CPU tensors: one plain call, no launch."""
    launches, calls = flash_attention.launches, tref.attention_ref.calls
    out = flash_attention(*ts[:3], causal=causal, window=window)
    assert flash_attention.launches == launches
    assert tref.attention_ref.calls == calls + 1
    return out


# ---------------------------------------------------------------------------
# the blocked form against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("s", LENGTHS)
def test_blocked_forward_matches_reference(s, case, dtype):
    h, kh, dqk, dv, window = CASES[case]
    ts, js = _inputs(s, h, kh, dqk, dv, dtype, seed=s)
    got = _port(ts, True, window)
    assert got.dtype == DTYPES[dtype][0] and got.shape == (1, s, h, dv)
    np.testing.assert_allclose(_np(got), _np(_reference(js, True, window)),
                               **DTYPES[dtype][2])


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("s", LENGTHS)
def test_blocked_gradient_matches_reference(s, case):
    """dq, dk, dv of sum(o * cot) against ``jax.grad`` of the reference's
    blocked form (jitted)."""
    h, kh, dqk, dv, window = CASES[case]
    ts, js = _inputs(s, h, kh, dqk, dv, seed=s + 1)
    cot = js[3]
    want = jax.jit(jax.grad(
        lambda q, k, v: jnp.sum(_reference((q, k, v), True, window) * cot),
        argnums=(0, 1, 2)))(*js[:3])
    leaves = [t.requires_grad_(True) for t in ts[:3]]
    out = _port(ts, True, window)
    got = torch.autograd.grad((out * ts[3]).sum(), leaves)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.float32
        w = _np(w)
        np.testing.assert_allclose(_np(g), w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_SHARE * np.abs(w).max(),
                                   err_msg=name)


def test_blocked_gradient_in_bf16_comes_back_in_bf16():
    ts, _ = _inputs(2100, 4, 1, 16, 16, "bf16", seed=5)
    leaves = [t.requires_grad_(True) for t in ts[:3]]
    out = _port(ts, True, 300)
    got = torch.autograd.grad((out.float() * ts[3].float()).sum(), leaves)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3
    assert all(bool(torch.isfinite(g.float()).all()) for g in got)


@pytest.mark.parametrize("window", [None, 1500])
def test_noncausal_whole_blocks_match_reference_blocked_form(window):
    """S 4,096 is four whole blocks: no padded key, so the reference's
    non-causal blocked form computes the intended function."""
    ts, js = _inputs(4096, 4, 2, 16, 16, seed=11)
    got = _port(ts, False, window)
    np.testing.assert_allclose(_np(got), _np(_reference(js, False, window)),
                               **F32_TOL)


@pytest.mark.parametrize("window", [None, 512])
def test_noncausal_ragged_keys_match_reference_direct_form(monkeypatch,
                                                           window):
    """The departure: at S 2,100 the last block holds 52 keys and 972 of
    padding, which the port masks in every mode.  It equals the
    reference's direct form, forward and gradient."""
    ts, js = _inputs(2100, 2, 1, 16, 16, seed=12)
    monkeypatch.setattr(jattn, "ANALYSIS_DIRECT_ATTENTION", True)
    cot = js[3]
    want, vjp = jax.vjp(lambda q, k, v: _reference((q, k, v), False, window),
                        *js[:3])
    want_grads = vjp(cot)
    leaves = [t.requires_grad_(True) for t in ts[:3]]
    got = _port(ts, False, window)
    np.testing.assert_allclose(_np(got), _np(want), **F32_TOL)
    grads = torch.autograd.grad((got * ts[3]).sum(), leaves)
    for name, g, w in zip("qkv", grads, want_grads):
        w = _np(w)
        np.testing.assert_allclose(_np(g), w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_SHARE * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("window", [None, 512])
def test_reference_blocked_form_lets_padded_keys_in_when_noncausal(
        monkeypatch, window):
    """Why the port departs: the reference's own blocked and direct forms
    differ by more than 1e-2 of the largest output at S 2,100, non-causal.
    If the reference is ever fixed, this test fails and says so."""
    _, js = _inputs(2100, 2, 1, 16, 16, seed=12)
    blocked = _np(_reference(js, False, window))
    monkeypatch.setattr(jattn, "ANALYSIS_DIRECT_ATTENTION", True)
    direct = _np(_reference(js, False, window))
    assert np.abs(blocked - direct).max() > 1e-2 * np.abs(direct).max()


# ---------------------------------------------------------------------------
# the threshold, and what the backward keeps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_threshold_direct_at_2048_blocked_past_it(causal):
    """Sq·Sk = 2048² stays the direct form, bit for bit; one key more
    takes the blocked form.  One plain call each."""
    for s, form in ((2048, "direct"), (2049, "blocked")):
        ts, _ = _inputs(s, 2, 1, 16, 16, seed=s)
        got = _port(ts, causal, None)
        pos = torch.arange(s)
        if form == "direct":
            want = tref.grouped_attention(*ts[:3], pos, pos, causal=causal,
                                          window=None)
        else:
            want = tref.grouped_attention_blocked(*ts[:3], pos, pos,
                                                  causal=causal, window=None)
        assert torch.equal(got, want), (s, form)


@pytest.mark.parametrize("causal", [True, False])
def test_backward_saves_no_score_sized_tensor(causal):
    """What autograd keeps for the blocked form's backward: q, k, v, the
    positions, the output and each row's log-sum-exp; nothing with both
    an Sq and an Sk extent.  The direct form, under the same hooks, does
    keep one (so the check can see it)."""
    sq, sk = 2100, 2300
    ts, _ = _inputs(sq, 4, 2, 16, 16, seed=3, sk=sk)

    def saved_shapes(fn):
        shapes = []

        def pack(t):
            shapes.append(tuple(t.shape))
            return t
        leaves = [t.requires_grad_(True) for t in ts[:3]]
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = fn(*leaves, torch.arange(sq), torch.arange(sk),
                     causal=causal, window=None)
        torch.autograd.grad(out.sum(), leaves)
        return shapes

    def score_sized(shape):
        return sq in shape and sk in shape

    blocked = saved_shapes(tref.grouped_attention_blocked)
    assert blocked and not any(map(score_sized, blocked)), blocked
    assert max(int(np.prod(s)) for s in blocked) < sq * sk
    assert any(map(score_sized, saved_shapes(tref.grouped_attention)))


# ---------------------------------------------------------------------------
# the models past 2048²
# ---------------------------------------------------------------------------

# arch -> smoke overrides: GQA; GQA with sliding windows across the block
# edges; RG-LRU with a local layer; MLA with the MTP head
LM_CASES = {
    "qwen1.5-0.5b": ("qwen1.5-0.5b", {}),
    "qwen1.5-0.5b_swa": ("qwen1.5-0.5b",
                         dict(block_pattern=("swa",), window=1500)),
    "recurrentgemma-9b_local": ("recurrentgemma-9b",
                                dict(block_pattern=("rglru", "local"),
                                     window=300)),
    "deepseek-v3-671b_mtp": ("deepseek-v3-671b", {}),
}


@pytest.mark.parametrize("case", list(LM_CASES))
def test_lm_loss_past_2048_squared_matches_reference(case):
    """2 x 2,100 tokens: every attention layer in the blocked form, the
    loss head in chunks; the loss with per-sample weights and its
    gradient leaf by leaf in the reference's stacked layout against
    ``jax.grad``."""
    arch, over = LM_CASES[case]
    jcfg = jconfigs.get_config(arch).smoke(**over)
    tcfg = tconfigs.get_config(arch).smoke(**over)
    kinds = {kind for kind, _ in ttfm.layer_sigs(tcfg)}
    assert kinds & {"attn", "swa", "local"}
    jp = jbuild(jcfg, tp=1, dp=1).init(jax.random.PRNGKey(1))
    tp = lm_params_from_jax(tcfg, jax.tree.map(np.asarray, jp))
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 2101))
    w = np.array([0.5, 1.5], np.float32)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda p, t, sw: jtfm.lm_loss(p, t, jcfg, sample_weights=sw)))(
        jp, jnp.asarray(toks), jnp.asarray(w))
    view, leaves = trainable(tp)
    calls = tref.attention_ref.calls
    loss = ttfm.lm_loss(view, torch.from_numpy(toks), tcfg,
                        sample_weights=torch.from_numpy(w))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    attn_layers = sum(k != "rglru" for k, _ in ttfm.layer_sigs(tcfg)) \
        + tcfg.mtp_depth
    assert tref.attention_ref.calls == calls + attn_layers
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               **LOSS_TOL)
    by_name = dict(zip(leaves, grads))
    got = tckpt._flatten(lm_params_to_stacked(
        tcfg, map_named(tp, lambda name, _: by_name[name])))
    want = jckpt._flatten(jgrad)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **MODEL_GRAD_TOL,
                                   err_msg=k)


def test_head_xent_in_chunks_is_softmax_xent():
    """Past ``HEAD_CHUNK`` tokens the loss head takes its logits a chunk
    at a time: the same loss and gradient as ``softmax_xent`` of the whole
    logits."""
    cfg = tconfigs.get_config("recurrentgemma-9b").smoke()   # softcap 30
    rng = np.random.default_rng(4)
    n = ttfm.HEAD_CHUNK + 300
    h = torch.from_numpy(rng.standard_normal((2, n // 2, cfg.d_model))
                         .astype(np.float32)).requires_grad_(True)
    w = torch.from_numpy(0.05 * rng.standard_normal(
        (cfg.d_model, cfg.padded_vocab)).astype(np.float32)) \
        .requires_grad_(True)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, n // 2)))
    labels[0, :7] = -1
    sw = torch.tensor([0.25, 2.0])
    from repro_torch.models.layers import unembed
    got = ttfm.head_xent(w, h, labels, cfg, sw)
    want = ttfm.softmax_xent(unembed(w, h, cfg), labels, cfg.padded_vocab,
                             sw)
    np.testing.assert_allclose(float(got.detach()), float(want.detach()),
                               rtol=1e-6)
    for g, gw in zip(torch.autograd.grad(got, (h, w)),
                     torch.autograd.grad(want, (h, w))):
        np.testing.assert_allclose(_np(g), _np(gw), rtol=1e-5,
                                   atol=1e-5 * float(gw.abs().max()))


@pytest.mark.parametrize("weighted", [False, True])
def test_head_xent_in_one_chunk_is_softmax_xent_bitwise(weighted):
    """Up to ``HEAD_CHUNK`` tokens the loss head is one chunk, not
    checkpointed: the loss and gradient bitwise those of ``softmax_xent``
    of the whole logits."""
    cfg = tconfigs.get_config("recurrentgemma-9b").smoke()   # softcap 30
    rng = np.random.default_rng(5)
    n = ttfm.HEAD_CHUNK
    h = torch.from_numpy(rng.standard_normal((2, n // 2, cfg.d_model))
                         .astype(np.float32)).requires_grad_(True)
    w = torch.from_numpy(0.05 * rng.standard_normal(
        (cfg.d_model, cfg.padded_vocab)).astype(np.float32)) \
        .requires_grad_(True)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, n // 2)))
    labels[1, -5:] = -1
    sw = torch.tensor([0.5, 1.5]) if weighted else None
    from repro_torch.models.layers import unembed
    got = ttfm.head_xent(w, h, labels, cfg, sw)
    want = ttfm.softmax_xent(unembed(w, h, cfg), labels, cfg.padded_vocab,
                             sw)
    assert torch.equal(got, want)
    for g, gw in zip(torch.autograd.grad(got, (h, w)),
                     torch.autograd.grad(want, (h, w))):
        assert torch.equal(g, gw)


@pytest.mark.parametrize("weighted", [False, True])
def test_seq2seq_loss_with_2100_frames_matches_reference_direct_form(
        monkeypatch, weighted):
    """The encoder's self-attention over 2,100 frames is non-causal and
    past 2048², with a ragged last block: the port's blocked form masks
    the padding and equals the reference run in its direct form, loss and
    gradient."""
    ecfg = dict(n_layers=1, encoder_layers=1)
    jcfg = jconfigs.get_config("seamless-m4t-medium").smoke(**ecfg)
    tcfg = tconfigs.get_config("seamless-m4t-medium").smoke(**ecfg)
    jp = jax.tree.map(np.asarray,
                      jbuild(jcfg, tp=1, dp=1).init(jax.random.PRNGKey(3)))
    tp = encdec_params_from_jax(tcfg, jp)
    rng = np.random.default_rng(5)
    frames = rng.standard_normal((2, 2100, jcfg.d_model)).astype(np.float32)
    toks = rng.integers(0, jcfg.vocab_size, (2, 14))
    sw = np.array([0.5, 1.5], np.float32) if weighted else None
    monkeypatch.setattr(jattn, "ANALYSIS_DIRECT_ATTENTION", True)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda p, f, t, w: jencdec.seq2seq_loss(p, f, t, jcfg,
                                                sample_weights=w)))(
        jp, jnp.asarray(frames), jnp.asarray(toks),
        None if sw is None else jnp.asarray(sw))
    view, leaves = trainable(tp)
    loss = tencdec.seq2seq_loss(view, torch.from_numpy(frames),
                                torch.from_numpy(toks), tcfg,
                                None if sw is None else torch.from_numpy(sw))
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               **ENCDEC_TOL)
    want = encdec_params_from_jax(
        tcfg, jax.tree.map(np.asarray, jgrad)).state_dict()
    assert sorted(grads) == sorted(want)
    for name, g in want.items():
        np.testing.assert_allclose(_np(grads[name]), _np(g), **ENCDEC_TOL,
                                   err_msg=name)


def test_train_entry_point_past_2048_tokens_on_the_cpu(capsys):
    """``launch.train --seq 2100``: 4 clients x 2,100 tokens, every train
    forward's attention in the blocked form, no kernel launch."""
    before = (flash_attention.launches, tref.attention_ref.calls)
    res = ttrain.main(["--smoke", "--device", "cpu", "--seq", "2100",
                       "--steps", "2"])
    assert "final_loss=" in capsys.readouterr().out
    assert flash_attention.launches == before[0]
    # 2 train steps and the eval, 2 layers each
    assert tref.attention_ref.calls == before[1] + 3 * 2
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))
    assert np.isfinite(res.held_out) and res.stats["seq"] == 2100


# ---------------------------------------------------------------------------
# the input shapes and the registry
# ---------------------------------------------------------------------------

def test_shapes_and_registry_match_reference():
    assert list(tconfigs.SHAPES) == list(jconfigs.SHAPES)
    for name, shape in jconfigs.SHAPES.items():
        assert dataclasses.asdict(tconfigs.get_shape(name)) \
            == dataclasses.asdict(shape)
    assert tconfigs.TRAIN_4K.seq_len == 4096
    with pytest.raises(ValueError, match="unknown shape"):
        tconfigs.get_shape("train_8k")
    for arch in tconfigs.ARCH_IDS:
        assert tconfigs.long_context_ok(arch) == jconfigs.long_context_ok(
            arch), arch
        assert tconfigs.supported_shapes(arch) \
            == jconfigs.supported_shapes(arch), arch
