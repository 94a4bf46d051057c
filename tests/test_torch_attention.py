"""Kernel K3's plain version and its wrapper on the CPU against the
reference.

The port's ``kernels.ref.attention_ref``, reached through the K3 wrapper
``kernels.flash_attention.flash_attention`` on CPU tensors (no launch, one
plain call), against ``repro.kernels.ref.attention_ref`` (the oracle of
the Pallas kernel, which cannot run on the installed jax) and against
``repro.models.attention.grouped_attention``, in its direct and its
blocked (Sq·Sk > 2048², online softmax over key blocks) branches, on the
same numpy-seeded inputs.  The sweep is the reference's own
(``tests/test_kernels.py``), plus windows, the non-causal case and
recurrentgemma's local layers (head_dim 256, 16 heads over one KV head,
a window shorter than the prompt), whose gradient is held against
``jax.grad`` of ``grouped_attention`` too, and MLA's prefill, whose v is
narrower than q and k (q.k width 192, v width 128; the reference's
``attention_ref`` takes one width, so it is held against
``grouped_attention`` alone).

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
from torch_ref import mm_tf32

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=6e-2, atol=6e-2)
DTYPES = {"f32": (torch.float32, jnp.float32, F32_TOL),
          "bf16": (torch.bfloat16, jnp.bfloat16, BF16_TOL)}


MLA = (192, 128)                # deepseek-v3's (q.k width, v width)


def _widths(dh):
    """(q.k width, v width) of one width or of a pair."""
    return (dh, dh) if isinstance(dh, int) else dh


def _inputs(b, sq, sk, h, kh, dh, dtype, seed=0):
    """q, k, v as torch tensors in ``dtype`` and the same values in JAX;
    ``dh`` is one width for q, k and v or the pair (q.k width, v width)."""
    tdt, jdt, _ = DTYPES[dtype]
    dqk, dv = _widths(dh)
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, sq, h, dqk), (b, sk, kh, dqk), (b, sk, kh, dv))]
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


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("window", [None, 48])
def test_attention_head_dim_256_matches_reference(window, dtype):
    """recurrentgemma's local attention at smoke length: Dh 256, H 16 over
    KH 1 (MQA), causal, a window of 48 shorter than the 130-token prompt
    (the kernel's 64-key tiles cross its edge), or none."""
    ts, js = _inputs(2, 130, 130, 16, 1, 256, dtype, seed=7)
    got = _port(ts, causal=True, window=window)
    tol = DTYPES[dtype][2]
    want = _np(jref.attention_ref(*js, causal=True, window=window))
    np.testing.assert_allclose(got, want, **tol)
    pos = jnp.arange(130)
    grouped = _np(jattn.grouped_attention(*js, pos, pos, causal=True,
                                          window=window))
    np.testing.assert_allclose(got, grouped, **tol)


@pytest.mark.parametrize("window", [None, 48])
def test_attention_head_dim_256_gradient_matches_reference(window):
    """The plain version's gradient at recurrentgemma's heads (the train
    forward differentiates it) against jax.grad of grouped_attention, at
    rtol 1e-5 plus 1e-5 of the gradient's largest magnitude (an entry sums
    many products; one that cancels keeps only the absolute part)."""
    import jax
    (q, k, v), (jq, jk, jv) = _inputs(1, 70, 70, 16, 1, 256, "f32", seed=8)
    cot = np.random.default_rng(9).standard_normal(q.shape).astype(
        np.float32)
    pos = jnp.arange(70)

    def jf(q, k, v):
        o = jattn.grouped_attention(q, k, v, pos, pos, causal=True,
                                    window=window)
        return jnp.sum(o * cot)
    want = jax.grad(jf, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention(*leaves, causal=True, window=window)
    got = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), leaves)
    for name, g, w in zip("qkv", got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("dqk,dv,h,kh", [(192, 128, 8, 8), (48, 32, 4, 4),
                                         (192, 128, 8, 2)])
@pytest.mark.parametrize("sq,sk,causal", [(100, 100, True), (37, 37, True),
                                          (64, 130, False)])
def test_attention_narrower_v_matches_reference(sq, sk, causal, dqk, dv, h,
                                                kh, dtype):
    """v narrower than q and k: MLA's (192, 128) at full width and its
    smoke width (48, 32), and with G 4: the output [B, Sq, H, Dv], scaled
    by 1/sqrt(q.k width), against the reference's grouped_attention."""
    ts, js = _inputs(2, sq, sk, h, kh, (dqk, dv), dtype, seed=10)
    got = _port(ts, causal=causal)
    assert got.shape == (2, sq, h, dv)
    want = _np(jattn.grouped_attention(
        *js, jnp.arange(sq), jnp.arange(sk), causal=causal, window=None))
    np.testing.assert_allclose(got, want, **DTYPES[dtype][2])


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
    in f32, then the 1/sqrt(Dqk) scale, the mask and an f32 softmax; the
    weights P rounded to bf16 for P.V (f32 sums), l summed over the f32 p;
    one cast of the output."""
    b, sq, h, dh = q.shape
    dv = v.shape[-1]
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
    return (o / l).permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv).bfloat16()


@pytest.mark.parametrize("dh", [64, 128, 256, pytest.param(MLA, id="192x128")])
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


# K3's f32 precision argument.  The kernel (``csrc/flash_attention.cu``)
# runs S = Q.K^T and each tile's P.V on the tensor cores in TF32 (a
# significand of 11 bits): one pass misses F32_TOL; three passes (small .
# big + big . small + big . big, small = the TF32 rounding of v - big) keep
# it, with the softmax in base 2 as the kernel takes it.


def _f32_kernel_form(q, k, v, *, causal, window, passes):
    """K3's f32 arithmetic in plain torch: q scaled by log2(e)/sqrt(Dh) in
    f32 before the product; key tiles of 64 (Dh 64) or 32 (Dh 128, 256,
    MLA's q.k width 192, whose v is 128 wide) walked from the last down
    (at Dh 256 the kernel splits the output's
    columns over two blocks, which leaves each column's arithmetic as it
    is); S = Q.K^T and each tile's P.V as TF32 products
    (``passes`` 1, or 3 for 3xTF32) with f32 sums, P.V's keys in each 8-key
    slab in the order the kernel's registers hold them (A's column t is key
    2t, t + 4 is 2t + 1); masked scores -1e30, keys past Sk -inf; the
    online softmax (m, l, acc) in f32 and base 2 (p = 2^(s - m));
    o = acc / max(l, 1e-30)."""
    b, sq, h, dh = q.shape
    sk, kh, dv = k.shape[1], k.shape[2], v.shape[3]
    tile = 64 if dh == 64 else 32
    scale = (torch.tensor(1.4426950408889634)
             / torch.sqrt(torch.tensor(float(dh))))
    qs = q.permute(0, 2, 1, 3) * scale                       # [B, H, Sq, Dh]
    kt, vt = (torch.nn.functional.pad(
        x.permute(0, 2, 1, 3).repeat_interleave(h // kh, 1),
        (0, 0, 0, (-sk) % tile)) for x in (k, v))            # [B, H, Sk', Dh]
    order = torch.arange(tile).view(-1, 8)[:, [0, 2, 4, 6, 1, 3, 5, 7]]
    order = order.reshape(-1)
    pos_q = torch.arange(sq)[:, None]
    m = torch.full((b, h, sq), tref.NEG_INF)
    l, acc = torch.zeros(b, h, sq), torch.zeros(b, h, sq, dv)
    for k0 in range(kt.shape[2] - tile, -1, -tile):
        s = mm_tf32(qs, kt[:, :, k0:k0 + tile].transpose(-1, -2), passes)
        pos_k = k0 + torch.arange(tile)[None, :]
        keep = torch.ones(sq, tile, dtype=torch.bool)
        if causal:
            keep &= pos_k <= pos_q
        if window is not None:
            keep &= pos_k > pos_q - window
        s = torch.where(keep, s, tref.NEG_INF)
        s = torch.where(pos_k < sk, s, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + mm_tf32(
            p[..., order], vt[:, :, k0 + order], passes)
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).permute(0, 2, 1, 3)


def _share_of_f32_tol(sq, sk, h, kh, dh, causal, window, passes, seed=6):
    """max |got - want| / (atol + rtol |want|) of the emulation against
    the plain version (<= 1 is within F32_TOL)."""
    ts, _ = _inputs(2, sq, sk, h, kh, dh, "f32", seed=seed)
    got = _f32_kernel_form(*ts, causal=causal, window=window, passes=passes)
    want = tref.attention_ref(*ts, causal=causal, window=window)
    return float(((got - want).abs()
                  / (F32_TOL["atol"] + F32_TOL["rtol"] * want.abs())).max())


@pytest.mark.parametrize("sq,sk,h,kh,dh,causal,window", [
    (128, 128, 4, 4, 64, True, None), (100, 100, 4, 2, 64, True, None),
    (1, 512, 8, 1, 64, True, None), (65, 65, 8, 1, 128, True, None),
    (129, 129, 10, 2, 128, True, None), (256, 256, 4, 2, 128, True, 16),
    (300, 300, 8, 2, 64, True, 8), (200, 200, 4, 2, 64, False, 100),
    (100, 300, 4, 2, 64, False, None), (300, 100, 4, 2, 128, False, None),
    (130, 130, 16, 1, 256, True, None), (200, 200, 16, 1, 256, True, 48),
    (129, 129, 8, 8, MLA, True, None), (37, 37, 8, 8, MLA, True, None),
    (300, 300, 4, 2, MLA, True, 16)])
def test_f32_kernel_3xtf32_within_tolerance(sq, sk, h, kh, dh, causal,
                                            window):
    """3xTF32 products on the kernel's tiles, with its key order and online
    softmax, stay within F32_TOL of the plain version: Dh 64, 128 and 256,
    MLA's (192, 128), GQA (G up to 16, and 5), windows, non-causal calls,
    ragged S."""
    assert _share_of_f32_tol(sq, sk, h, kh, dh, causal, window,
                             passes=3) <= 1.0


def test_f32_kernel_single_pass_tf32_misses_tolerance():
    """Why K3 f32 pays for three products: at the qwen3 widths (H 16,
    KH 8, Dh 128; B 2, S 512) one TF32 pass misses F32_TOL 59.3-fold on
    this seed (the rows that see few keys take V's TF32 rounding, 2^-12
    relative, almost whole), while three passes sit at 0.063 of it."""
    args = (512, 512, 16, 8, 128, True, None)
    assert _share_of_f32_tol(*args, passes=1) > 10
    assert _share_of_f32_tol(*args, passes=3) < 0.2


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


@pytest.mark.parametrize("pair", [(192, 192), (128, 64), (192, 64),
                                  (64, 128), (48, 32)])
def test_kernel_refuses_a_pair_it_has_no_instance_of(pair):
    """The kernel's instances are (64, 64), (128, 128), (256, 256) and
    MLA's (192, 128): any other (q.k width, v width) raises ValueError on
    the card's path (the plain version on the CPU takes any pair)."""
    from repro_torch.kernels.flash_attention import HEAD_DIMS, check_instance
    assert MLA in HEAD_DIMS
    with pytest.raises(ValueError, match="v width"):
        check_instance(*pair)
    for dqk, dv in HEAD_DIMS:
        check_instance(dqk, dv)
