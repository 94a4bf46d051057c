"""Kernel K3's plain version and its wrapper on the CPU against the
reference.

The port's ``kernels.ref.attention_ref``, reached through the K3 wrapper
``kernels.flash_attention.flash_attention`` on CPU tensors (no launch, one
plain call), against ``repro.kernels.ref.attention_ref`` (the oracle of
the Pallas kernel, which cannot run on the installed jax) and against
``repro.models.attention.grouped_attention``, in its direct and its
blocked (Sq·Sk > 2048², online softmax over key blocks) branches, on the
same numpy-seeded inputs.  The sweep is the reference's own
(``tests/test_kernels.py``), plus windows and the non-causal case.

Tolerances: f32 at 2e-5 rel/abs (scores and softmax in f32 on both sides,
sums in another order); bf16 outputs compared in f32 at 6e-2, the
reference test's own bf16 tolerance (one bf16 ulp after the f32 math).
The CUDA kernel is held against this plain version on the card
(``test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=6e-2, atol=6e-2)
DTYPES = {"f32": (torch.float32, jnp.float32, F32_TOL),
          "bf16": (torch.bfloat16, jnp.bfloat16, BF16_TOL)}


def _inputs(b, sq, sk, h, kh, dh, dtype, seed=0):
    """q, k, v as torch tensors in ``dtype`` and the same values in JAX."""
    tdt, jdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, sq, h, dh), (b, sk, kh, dh), (b, sk, kh, dh))]
    ts = [torch.from_numpy(a).to(tdt) for a in arrs]
    js = [jnp.asarray(t.float().numpy()).astype(jdt) for t in ts]
    return ts, js


def _port(ts, **kw):
    """The wrapper on CPU tensors: the plain version, no launch."""
    launches, calls = flash_attention.launches, tref.attention_ref.calls
    out = flash_attention(*ts, **kw)
    assert flash_attention.launches == launches
    assert tref.attention_ref.calls == calls + 1
    return out.float().numpy()


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("h,kh", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("sq,sk", [(128, 128), (256, 256), (64, 256),
                                   (1, 512), (100, 100)])
def test_attention_sweep_matches_reference(sq, sk, h, kh, dtype):
    ts, js = _inputs(2, sq, sk, h, kh, 64, dtype)
    got = _port(ts, causal=True)
    assert ts[0].dtype == DTYPES[dtype][0]
    want = _np(jref.attention_ref(*js, causal=True))
    np.testing.assert_allclose(got, want, **DTYPES[dtype][2])
    grouped = _np(jattn.grouped_attention(
        *js, jnp.arange(sq), jnp.arange(sk), causal=True, window=None))
    np.testing.assert_allclose(got, grouped, **DTYPES[dtype][2])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [16, 64, 128])
def test_attention_window_matches_reference(window, causal):
    ts, js = _inputs(1, 256, 256, 4, 2, 32, "f32", seed=1)
    got = _port(ts, causal=causal, window=window)
    want = _np(jref.attention_ref(*js, causal=causal, window=window))
    np.testing.assert_allclose(got, want, **F32_TOL)
    pos = jnp.arange(256)
    grouped = _np(jattn.grouped_attention(*js, pos, pos, causal=causal,
                                          window=window))
    np.testing.assert_allclose(got, grouped, **F32_TOL)


@pytest.mark.parametrize("sq,sk", [(128, 128), (100, 300)])
def test_attention_noncausal_matches_reference(sq, sk):
    ts, js = _inputs(1, sq, sk, 2, 2, 32, "f32", seed=2)
    got = _port(ts, causal=False)
    want = _np(jref.attention_ref(*js, causal=False))
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("window", [None, 300])
def test_attention_matches_blocked_grouped_attention(window):
    """Sq·Sk > 2048²: the reference's online softmax over 1024-key blocks
    (the padded keys of the last block masked by position)."""
    s = 2100
    assert s * s > 2048 * 2048
    ts, js = _inputs(1, s, s, 2, 1, 64, "f32", seed=3)
    got = _port(ts, causal=True, window=window)
    pos = jnp.arange(s)
    blocked = _np(jattn.grouped_attention(*js, pos, pos, causal=True,
                                          window=window))
    np.testing.assert_allclose(got, blocked, **F32_TOL)


def test_attention_at_an_offset_is_the_same():
    """Prefill at pos_offset > 0: q and k share positions, so the offset
    cancels in both masks and K3's positions from 0 give the answer."""
    ts, js = _inputs(1, 96, 96, 4, 2, 64, "f32", seed=4)
    got = _port(ts, causal=True, window=40)
    pos = 1000 + jnp.arange(96)
    want = _np(jattn.grouped_attention(*js, pos, pos, causal=True, window=40))
    np.testing.assert_allclose(got, want, **F32_TOL)


ATTN_BF16_TOL = dict(rtol=1.6e-2, atol=1e-2)   # as chip_smoke.py's


def _bf16_kernel_form(q, k, v, *, causal):
    """K3's bf16 rounding in plain torch: the unscaled bf16 products summed
    in f32, then the 1/sqrt(Dh) scale, the mask and an f32 softmax; the
    weights P rounded to bf16 for P.V (f32 sums), l summed over the f32 p;
    one cast of the output."""
    b, sq, h, dh = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, sq, kh, h // kh, dh).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    s = s * torch.tensor(1.0 / dh ** 0.5, dtype=torch.float32)
    if causal:
        pos_q, pos_k = torch.arange(sq), torch.arange(k.shape[1])
        s = torch.where(pos_k[None, :] <= pos_q[:, None], s, tref.NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bkgqs,bskd->bkgqd", p.bfloat16().float(), v.float())
    return (o / l).permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh).bfloat16()


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("h,kh", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("sq,sk", [(128, 128), (256, 256), (64, 256),
                                   (1, 512), (100, 100)])
def test_bf16_kernel_rounding_within_tolerance(sq, sk, h, kh, dh):
    """Rounding P to bf16, as the CUDA kernel's tensor-core P.V does, keeps
    the output within the kernel's bf16 tolerance of the plain version."""
    ts, _ = _inputs(2, sq, sk, h, kh, dh, "bf16", seed=5)
    got = _bf16_kernel_form(*ts, causal=True).float().numpy()
    want = tref.attention_ref(*ts, causal=True).float().numpy()
    np.testing.assert_allclose(got, want, **ATTN_BF16_TOL)


def test_wrapper_rejects_what_no_version_takes():
    ts, _ = _inputs(1, 8, 8, 4, 2, 64, "f32")
    q, k, v = ts
    with pytest.raises(ValueError):
        flash_attention(q, k[..., :32], v[..., :32])          # head_dim
    with pytest.raises(ValueError):
        flash_attention(q[:, :, :3], k, v)                     # KH ∤ H
    with pytest.raises(ValueError):
        flash_attention(q, k, v[:, :4])                        # k, v shapes
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :2], v[:, :2], window=4)       # empty rows
    with pytest.raises(TypeError):
        flash_attention(q, k.double(), v.double())
