"""The blocked form of K3's plain version on the CPU against the reference
(the long-sequence train path it opens is in
``test_torch_blocked_attention_lm.py``).

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
- no tensor saved for backward has an Sq x Sk extent.

Tolerances: f32 outputs at 2e-5 (``test_torch_attention.py``'s F32_TOL);
bf16 outputs compared in f32 at 6e-2; gradients at rtol 1e-5 plus 1e-5 of
their largest magnitude (``test_torch_train.py``'s).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention
from torch_ref import one_thread  # noqa: F401 (autouse)

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=6e-2, atol=6e-2)
GRAD_RTOL, GRAD_ATOL_SHARE = 1e-5, 1e-5
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
