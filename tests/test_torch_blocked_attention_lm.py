"""The long-sequence paths that the blocked form of K3's plain version
opens (``kernels.ref.grouped_attention_blocked``, held on its own in
``test_torch_blocked_attention.py``), on the CPU against the reference:

- ``lm_loss`` and its gradient past 2048² at smoke width for GQA, swa,
  RG-LRU with a local layer and MLA with MTP;
- the loss head in chunks (``transformer.head_xent``) against
  ``softmax_xent`` of the whole logits;
- ``seq2seq_loss`` with 2,100 frames against the reference's direct form;
- ``launch.train`` end to end at 2,100 tokens;
- the input shapes of ``configs.shapes`` and the registry's
  ``long_context_ok`` / ``supported_shapes``.

Tolerances: the losses at rtol 1e-5 / atol 1e-6 and the model's gradients
at rtol 1e-4 / atol 1e-6 (``test_torch_train.py`` and
``test_torch_mla.py``); the encoder-decoder's loss and gradients at rtol
1e-4 / atol 1e-5 (``test_torch_encdec.py``'s).
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
from torch_ref import one_thread  # noqa: F401 (autouse)

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
ENCDEC_TOL = dict(rtol=1e-4, atol=1e-5)


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


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
