"""The port's CUDA kernels K1, K2, K3 and K4 against their plain PyTorch
versions on the card.

Needs an NVIDIA GPU and nvcc; every test skips without a CUDA device.
This file imports no JAX, so it also runs on a machine with the card and
no JAX installed:

    python -m pytest -q --noconftest tests/test_torch_kernels_cuda.py

K1 and K2 take their plain versions' order of f32 operations, so they
are held to them bit for bit (``torch.equal``) over every misalignment
class of a row, bases off 16-byte alignment and rows shorter than one
vector; the tolerance cases stay beside them.  Tolerances: f32 outputs
agree to 2e-5 (the reference's own kernel tolerance); a bf16 output
compared in f32 at 6e-2 (as the reference's bf16 kernel sweeps).  K3 (flash attention)
keeps its scores, softmax and accumulator in f32 like its plain version;
its bf16 path also rounds the softmax weights P to bf16 for the tensor
cores' P.V product (2^-9 relative per weight, averaged over the keys),
and its f32 path runs both products in 3xTF32 (about f32's precision;
``tests/test_torch_attention.py`` emulates it): f32 holds at 2e-5, and bf16 outputs at two bf16 ulps (rtol 1.6e-2)
plus 1e-2, well under a typical output (about sqrt(e / Sk) for
unit-variance inputs), so a wrong row fails.  K4 (the SSD scan) sums terms
as large as its largest output, in another order and over its own tile of
64 rows against the plain version's chunk, its products in 3xTF32 (about
f32's precision; ``tests/test_torch_ssm.py`` emulates it): f32 agrees to
about 1e-5 of the largest |y| (measured on the card), so y and the state
are held at 1e-4 of their largest magnitude plus 2e-4 relative (the
reference's SSD tolerance); a bf16 y may then land one bf16 ulp apart, so
1.6e-2 relative (two ulps) instead.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ota_aggregate, ref, round_step
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan

pytestmark = pytest.mark.cuda

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=6e-2, atol=6e-2)
ATTN_BF16_TOL = dict(rtol=1.6e-2, atol=1e-2)
SHAPES = [(1, 1, 1), (1, 10, 128), (3, 10, 5000), (2, 32, 1027),
          (7, 10, 814090)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(c, n, d, seed=0):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((c, n, d)).astype(np.float32)
    s = rng.uniform(0, 0.2, (c, n)).astype(np.float32)
    s[:, 0] = 0.0                                  # a truncated device
    z = rng.standard_normal((c, d)).astype(np.float32)
    p = rng.standard_normal((c, d)).astype(np.float32)
    ns = rng.uniform(0, 0.1, (c,)).astype(np.float32)
    eta = rng.uniform(0.01, 0.1, (c,)).astype(np.float32)
    return [torch.from_numpy(a) for a in (g, s, z, p, ns, eta)]


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("c,n,d", SHAPES)
def test_round_step_kernel_matches_plain(cuda, wire, c, n, d):
    g, s, z, p, ns, eta = (t.to(cuda) for t in _inputs(c, n, d))
    w, qs = ops.quantize_uplink(g, wire)
    want = ref.ota_round_step_ref(w, s, z, ns, p, eta, q_scale=qs)
    before = round_step.ota_round_step.launches
    got = ops.ota_round_step_flat(w, s, z, ns, p, eta, qs)
    torch.cuda.synchronize()
    assert round_step.ota_round_step.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (c, d)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **F32_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,n,d", SHAPES)
def test_aggregate_kernel_matches_plain(cuda, dtype, c, n, d):
    g, s, z, _, ns, _ = (t.to(cuda) for t in _inputs(c, n, d, seed=1))
    g = g.to(dtype)
    want = ref.ota_aggregate_ref(g, s, z, ns)
    before = ota_aggregate.ota_aggregate.launches
    got = ops.ota_aggregate_flat(g, s, z, ns)
    torch.cuda.synchronize()
    assert ota_aggregate.ota_aggregate.launches == before + 1
    assert got.dtype == dtype and got.shape == (c, d)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               **(F32_TOL if dtype == torch.float32
                                  else BF16_TOL))


# Bitwise against the plain versions, which take the kernels' own order of
# f32 operations: every misalignment class of a row (D = 4096 + r, three
# cells, so that cell rows start at 0, D and 2D elements), D shorter than
# one 16-byte vector, N from 1 to 32 (the kernels issue the loads of 10
# device rows at a time, so N = 32 takes four groups), N = 32 on rows of
# whole 16-byte vectors too (on every wire), and the main shape
BITWISE_SHAPES = [(3, 10, 4096 + r) for r in range(16)] \
    + [(c, n, d) for c in (1, 7) for n in (1, 10, 32) for d in (1, 3, 7, 15)] \
    + [(2, 32, 1027), (3, 32, 4096 + 5), (7, 10, 814090)]


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("c,n,d", BITWISE_SHAPES)
def test_round_step_kernel_bitwise(cuda, wire, c, n, d):
    g, s, z, p, ns, eta = (t.to(cuda) for t in _inputs(c, n, d, seed=2))
    w, qs = ops.quantize_uplink(g, wire)
    want = ref.ota_round_step_ref(w, s, z, ns, p, eta, q_scale=qs)
    got = ops.ota_round_step_flat(w, s, z, ns, p, eta, qs)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,n,d", BITWISE_SHAPES)
def test_aggregate_kernel_bitwise(cuda, dtype, c, n, d):
    g, s, z, _, ns, _ = (t.to(cuda) for t in _inputs(c, n, d, seed=3))
    g = g.to(dtype)
    want = ref.ota_aggregate_ref(g, s, z, ns)
    got = ops.ota_aggregate_flat(g, s, z, ns)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _offset(t: torch.Tensor, k: int) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts ``k`` elements into a
    fresh buffer (so ``k * itemsize`` bytes off 16-byte alignment)."""
    buf = torch.zeros(t.numel() + 16, dtype=t.dtype, device=t.device)
    out = buf.view(-1)[k:k + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("k", [1, 2, 3, 7, 15])
def test_round_step_kernel_takes_offset_bases(cuda, wire, k):
    """g, z and p whose bases are not 16-byte aligned are taken: each
    stream is realigned from its own address."""
    c, n, d = 3, 10, 4099
    g, s, z, p, ns, eta = (t.to(cuda) for t in _inputs(c, n, d, seed=4))
    w, qs = ops.quantize_uplink(g, wire)
    want = ref.ota_round_step_ref(w, s, z, ns, p, eta, q_scale=qs)
    wk, zk, pk = _offset(w, k), _offset(z, (k + 1) % 4), _offset(p, 3)
    assert wk.data_ptr() % 16 != 0 and wk.is_contiguous()
    got = ops.ota_round_step_flat(wk, s, zk, ns, pk, eta, qs)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 2, 3, 7, 15])
def test_aggregate_kernel_takes_offset_bases(cuda, dtype, k):
    c, n, d = 3, 10, 4099
    g, s, z, _, ns, _ = (t.to(cuda) for t in _inputs(c, n, d, seed=5))
    g = g.to(dtype)
    want = ref.ota_aggregate_ref(g, s, z, ns)
    got = ops.ota_aggregate_flat(_offset(g, k), s, _offset(z, (k + 2) % 4),
                                 ns)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_kernels_reject_what_they_do_not_take(cuda):
    g, s, z, p, ns, eta = (t.to(cuda) for t in _inputs(2, 4, 300))
    qs = torch.ones_like(s)
    k1 = round_step.ota_round_step
    with pytest.raises(TypeError):
        k1(g.double(), qs, s, z, ns, p, eta)
    with pytest.raises(ValueError):
        k1(g, qs, s, z[:, :-1], ns, p, eta)
    with pytest.raises(ValueError):
        k1(g, qs, s, z.t().contiguous().t(), ns, p, eta)
    with pytest.raises(ValueError):
        k1(g, qs, s, z.cpu(), ns, p, eta)
    with pytest.raises(ValueError):
        k1(g.cpu(), qs, s, z, ns, p, eta)
    with pytest.raises(TypeError):
        ota_aggregate.ota_aggregate(g.to(torch.int8), s, z, ns)


def test_plain_version_not_called_on_cuda(cuda):
    g, s, z, p, ns, eta = (t.to(cuda) for t in _inputs(2, 4, 300))
    before = (ref.ota_round_step_ref.calls, ref.ota_aggregate_ref.calls)
    ops.ota_round_step_flat(g, s, z, ns, p, eta)
    ops.ota_aggregate_flat(g, s, z, ns)
    torch.cuda.synchronize()
    assert (ref.ota_round_step_ref.calls, ref.ota_aggregate_ref.calls) \
        == before


# K3: the reference's flash-attention sweep, head_dim 64, 128 and 256,
# plus a ragged S = 1000 at qwen3's heads; S at 127, 128, 129 and 255
# around the bf16 kernel's 128-row q tile and its 64- and 128-key tiles
# (Sq != Sk both ways), S at 63 and 65 around the f32 kernel's 64-row q
# tile, G = 8 at H = 32, the heads of granite-8b (32 over 8), qwen2.5-14b
# (40 over 8, G = 5) and chameleon-34b (64 over 8), recurrentgemma's
# (16 over 1) and mixtral-8x22b's (48 over 8, G = 6).  Each head-dim sweep
# takes the (q.k width, v width) pairs of the kernel's instances: 64, 128,
# 256 (both widths alike) and MLA's (192, 128)
ATTN_SHAPES = [(sq, sk, h, kh)
               for sq, sk in ((128, 128), (256, 256), (64, 256), (1, 512),
                              (100, 100), (127, 127), (129, 129), (255, 255),
                              (129, 255), (255, 127), (63, 63), (65, 65))
               for h, kh in ((4, 4), (4, 2), (8, 1), (32, 4), (32, 8),
                             (40, 8), (64, 8), (16, 1), (48, 8))] \
    + [(1000, 1000, 16, 8)]
MLA = (192, 128)
HEAD_DIMS = [64, 128, 256, pytest.param(MLA, id="192x128")]


def _qkv(cuda, b, sq, sk, h, kh, dh, dtype, seed=0):
    """q [b, sq, h, Dqk], k [b, sk, kh, Dqk], v [b, sk, kh, Dv]; ``dh``
    is one width for both or the pair (Dqk, Dv)."""
    dqk, dv = (dh, dh) if isinstance(dh, int) else dh
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(device=cuda, dtype=dtype)
            for s in ((b, sq, h, dqk), (b, sk, kh, dqk), (b, sk, kh, dv))]


def _check_attention(q, k, v, **kw):
    want = ref.attention_ref(q, k, v, **kw)
    before = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape[:3] + v.shape[3:]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               **(F32_TOL if q.dtype == torch.float32
                                  else ATTN_BF16_TOL))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("sq,sk,h,kh", ATTN_SHAPES)
def test_flash_attention_kernel_matches_plain(cuda, sq, sk, h, kh, dh,
                                              dtype):
    _check_attention(*_qkv(cuda, 2, sq, sk, h, kh, dh, dtype), causal=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("window", [16, 64, 100, 128, 200, 256])
def test_flash_attention_kernel_window_matches_plain(cuda, window, dh, causal,
                                                     dtype):
    _check_attention(*_qkv(cuda, 2, 1000, 1000, 16, 8, dh, dtype, seed=1),
                     causal=causal, window=window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_flash_attention_kernel_window_masks_whole_key_tiles(cuda, dh, causal,
                                                             dtype):
    """Window 8: every q tile loads the key tile below its own, and in it
    all keys are masked for most of the tile's rows (row q0 + r sees none
    of it once r >= 7), on top of the window's edge inside the diagonal
    tile; S = 300 leaves a ragged last tile."""
    _check_attention(*_qkv(cuda, 2, 300, 300, 8, 2, dh, dtype, seed=3),
                     causal=causal, window=8)


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_flash_attention_kernel_f32_long_sequence(cuda, dh):
    """S = 16,384: the last q tile walks 256 (Dh 64) or 512 (Dh 128, 256
    and MLA's 192 / 128) key tiles.  The tensor cores' accumulator truncates, so the f32 kernel
    sums each tile's P.V from zero and adds it to the output in f32; its
    error must not grow out of F32_TOL with the number of tiles."""
    _check_attention(*_qkv(cuda, 1, 16384, 16384, 2, 1, dh, torch.float32,
                           seed=4), causal=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_recurrentgemma_window(cuda, dtype):
    """recurrentgemma's local layers past their window: S = 4,096 over a
    window of 2,048 at its heads (16 over 1) and Dh 256, causal; the q
    tiles past the window skip the key tiles below it."""
    _check_attention(*_qkv(cuda, 2, 4096, 4096, 16, 1, 256, dtype, seed=6),
                     causal=True, window=2048)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s", [(8, 1024), (1, 8192)])
def test_flash_attention_kernel_mixtral_swa(cuda, b, s, dtype):
    """mixtral-8x22b's sliding-window layers: 48 heads over 8 (G = 6) at
    Dh 128 with its window of 4,096, at its serve prefill (8 x 1,024,
    where the window does not bite) and past the window (1 x 8,192)."""
    _check_attention(*_qkv(cuda, b, s, s, 48, 8, 128, dtype, seed=7),
                     causal=True, window=4096)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_batch_over_65535(cuda, dtype):
    """B = 65,536 rows of one head: more than a grid's y or z axis holds.
    Both kernels run one flat grid (its size checked in the entry), so the
    wrapper takes any batch and head count, as the reference does."""
    _check_attention(*_qkv(cuda, 65536, 16, 16, 1, 1, 64, dtype, seed=5),
                     causal=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk", [(128, 128), (100, 300), (300, 100),
                                   (129, 255), (255, 129)])
def test_flash_attention_kernel_noncausal_ragged_keys(cuda, sq, sk, dtype):
    """Non-causal calls take any Sk: keys past Sk are masked in the kernel."""
    _check_attention(*_qkv(cuda, 2, sq, sk, 4, 2, 64, dtype, seed=2),
                     causal=False)


# seamless-m4t-medium's non-causal calls: its encoder's self-attention
# (Sq = Sk = 1,024 frames) and cross-attention, a text prompt over audio
# frames (Sq 128 over Sk 1,024; Sq 1,000 over Sk 1,024 and Sq 1,024 over Sk
# 100, ragged key and query tiles), at its heads (16 over 16, G 1) and G 4
NONCAUSAL_SHAPES = [(1024, 1024), (128, 1024), (1000, 1024), (1024, 100)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", HEAD_DIMS)
@pytest.mark.parametrize("h,kh", [(16, 16), (16, 4)])
@pytest.mark.parametrize("sq,sk", NONCAUSAL_SHAPES)
def test_flash_attention_kernel_noncausal_matches_plain(cuda, sq, sk, h, kh,
                                                        dh, dtype):
    """Every q tile walks every key tile; the wrapper counts the launch as
    non-causal too."""
    before = flash_attention.noncausal_launches
    _check_attention(*_qkv(cuda, 2, sq, sk, h, kh, dh, dtype, seed=7),
                     causal=False)
    assert flash_attention.noncausal_launches == before + 1


def test_flash_attention_rejects_what_it_does_not_take(cuda):
    q, k, v = _qkv(cuda, 1, 64, 64, 4, 2, 64, torch.float32)
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        flash_attention(*_qkv(cuda, 1, 64, 64, 4, 2, 32, torch.float32))
    for pair in ((192, 192), (128, 64), (192, 64), (64, 128)):
        with pytest.raises(ValueError, match="v width"):
            flash_attention(*_qkv(cuda, 1, 64, 64, 4, 2, pair,
                                  torch.bfloat16))
    with pytest.raises(ValueError):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError):
        flash_attention(q, k.cpu(), v)
    for dtype in (torch.float32, torch.bfloat16):   # a base off 16 bytes
        qa, ka, va = (t.to(dtype) for t in (q, k, v))
        off = torch.empty(qa.numel() + 1, dtype=dtype,
                          device=cuda)[1:].view(qa.shape).copy_(qa)
        assert off.is_contiguous() and off.data_ptr() % 16
        with pytest.raises(ValueError):
            flash_attention(off, ka, va)


def test_flash_attention_plain_version_not_called_on_cuda(cuda):
    q, k, v = _qkv(cuda, 1, 64, 64, 4, 2, 64, torch.bfloat16)
    before = ref.attention_ref.calls
    flash_attention(q, k, v, window=16)
    torch.cuda.synchronize()
    assert ref.attention_ref.calls == before
    flash_attention(q, k, v, use_kernel=False)
    assert ref.attention_ref.calls == before + 1


# K4: the smoke model's and the full-width mamba2 scan, a ragged S, and an
# odd P, N pair; S around the kernel's 64-row tile (63, 64, 65, 129) at the
# mamba2 widths, and P = N = 96; each with G in (1, 2), with and without
# state0, f32 and bf16
SSD_SHAPES = [(2, 37, 16, 32, 32, 32), (8, 1024, 64, 64, 128, 128),
              (8, 1000, 64, 64, 128, 128), (1, 130, 4, 96, 64, 64),
              (2, 63, 4, 64, 128, 64), (2, 64, 4, 64, 128, 64),
              (2, 65, 4, 64, 128, 64), (2, 129, 4, 64, 128, 64),
              (1, 130, 4, 96, 96, 64)]
SSD_REL = {torch.float32: 2e-4, torch.bfloat16: 1.6e-2}


def _ssd_inputs(cuda, b, s, h, p, n, g, dtype, state, seed=0):
    """x, dt (> 0), a_neg (< 0), B, C as the reference's SSD tests draw
    them; a_neg and state0 in f32."""
    rng = np.random.default_rng(seed)

    def t(a, dt=dtype):
        return torch.from_numpy(a.astype(np.float32)).to(device=cuda,
                                                         dtype=dt)
    x = t(rng.standard_normal((b, s, h, p)))
    dt = t(np.log1p(np.exp(rng.standard_normal((b, s, h)))))
    a_neg = t(-np.exp(0.5 * rng.standard_normal(h)), torch.float32)
    bm = t(0.5 * rng.standard_normal((b, s, g, n)))
    cm = t(0.5 * rng.standard_normal((b, s, g, n)))
    s0 = t(rng.standard_normal((b, h, p, n)), torch.float32) if state \
        else None
    return x, dt, a_neg, bm, cm, s0


def _close_to_scale(got, want, rel):
    """|got - want| <= 1e-4 max|want| + rel |want|, in f32."""
    got, want = got.float(), want.float()
    bound = 1e-4 * want.abs().max() + rel * want.abs()
    assert bool(((got - want).abs() <= bound).all()), \
        float((got - want).abs().max())


def _check_ssd(x, dt, a_neg, bm, cm, s0, chunk):
    want_y, want_s = ref.ssd_chunked(x, dt, a_neg, bm, cm, chunk, state0=s0)
    launches, calls = ssd_scan.launches, ref.ssd_chunked.calls
    got_y, got_s = ssd_scan(x, dt, a_neg, bm, cm, chunk=chunk, state0=s0)
    torch.cuda.synchronize()
    assert ssd_scan.launches == launches + 1
    assert ref.ssd_chunked.calls == calls
    assert got_y.dtype == x.dtype and got_y.shape == x.shape
    assert got_s.dtype == torch.float32 and got_s.shape == want_s.shape
    assert bool(torch.isfinite(got_y).all() and torch.isfinite(got_s).all())
    _close_to_scale(got_y, want_y, SSD_REL[x.dtype])
    _close_to_scale(got_s, want_s, SSD_REL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_SHAPES)
def test_ssd_scan_kernel_matches_plain(cuda, b, s, h, p, n, chunk, g, state,
                                       dtype):
    _check_ssd(*_ssd_inputs(cuda, b, s, h, p, n, g, dtype, state), chunk)


@pytest.mark.parametrize("x_scale", [1.0, 1e3])
@pytest.mark.parametrize("n", [32, 64, 96, 128])
@pytest.mark.parametrize("p", [32, 64, 96, 128])
def test_ssd_scan_kernel_every_width(cuda, p, n, x_scale):
    """Every P, N pair; x scaled by 1e3 against B, C and state0 drawn as
    usual puts the TF32 products' error in the small halves at another
    magnitude than the others'."""
    x, *rest = _ssd_inputs(cuda, 1, 130, 4, p, n, 2, torch.float32, True,
                           seed=1)
    _check_ssd(x * x_scale, *rest, 64)


def test_ssd_scan_rejects_what_it_does_not_take(cuda):
    x, dt, a_neg, bm, cm, s0 = _ssd_inputs(cuda, 1, 64, 4, 64, 64, 1,
                                           torch.float32, True)
    with pytest.raises(ValueError):      # P not in (32, 64, 96, 128)
        ssd_scan(*_ssd_inputs(cuda, 1, 64, 4, 48, 64, 1, torch.float32,
                              False)[:5], chunk=32)
    with pytest.raises(ValueError):      # N not in (32, 64, 96, 128)
        ssd_scan(*_ssd_inputs(cuda, 1, 64, 4, 64, 16, 1, torch.float32,
                              False)[:5], chunk=32)
    with pytest.raises(ValueError):      # non-contiguous x
        ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, a_neg,
                 bm, cm, chunk=32)
    with pytest.raises(ValueError):      # CPU and CUDA mixed
        ssd_scan(x, dt, a_neg.cpu(), bm, cm, chunk=32)
    with pytest.raises(TypeError):       # float16
        ssd_scan(x.half(), dt.half(), a_neg, bm.half(), cm.half(), chunk=32)
    with pytest.raises(TypeError):       # mixed input dtypes
        ssd_scan(x, dt.bfloat16(), a_neg, bm, cm, chunk=32)
    with pytest.raises(TypeError):       # a bf16 state
        ssd_scan(x, dt, a_neg, bm, cm, chunk=32, state0=s0.bfloat16())
    for dtype in (torch.float32, torch.bfloat16):   # a base off 16 bytes
        xa, dta, bma, cma = (t.to(dtype) for t in (x, dt, bm, cm))
        off = torch.empty(xa.numel() + 1, dtype=dtype,
                          device=cuda)[1:].view(xa.shape).copy_(xa)
        assert off.is_contiguous() and off.data_ptr() % 16
        with pytest.raises(ValueError):
            ssd_scan(off, dta, a_neg, bma, cma, chunk=32)


@pytest.mark.parametrize("dh", [64, 256, pytest.param(MLA, id="192x128")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_refuse_autograd(cuda, dtype, dh):
    """K3 and K4 have no backward: in grad mode an input that requires grad
    raises (naming use_kernel=False) and launches nothing; under no_grad
    the kernel runs; use_kernel=False takes the plain version, which
    autograd differentiates (K3 at Dh 64, recurrentgemma's 256 and MLA's
    192 / 128)."""
    q, k, v = _qkv(cuda, 1, 64, 64, 4, 2, dh, dtype)
    x, dt, a_neg, bm, cm, s0 = _ssd_inputs(cuda, 1, 64, 4, 64, 64, 1,
                                           dtype, True)
    for t in (k, dt):
        t.requires_grad_(True)
    launches = (flash_attention.launches, ssd_scan.launches)
    with pytest.raises(RuntimeError, match="use_kernel=False"):
        flash_attention(q, k, v)
    with pytest.raises(RuntimeError, match="use_kernel=False"):
        ssd_scan(x, dt, a_neg, bm, cm, chunk=32, state0=s0)
    assert (flash_attention.launches, ssd_scan.launches) == launches
    with torch.no_grad():
        flash_attention(q, k, v)
        ssd_scan(x, dt, a_neg, bm, cm, chunk=32, state0=s0)
    assert (flash_attention.launches, ssd_scan.launches) \
        == (launches[0] + 1, launches[1] + 1)
    flash_attention(q, k, v, use_kernel=False).float().sum().backward()
    y, st = ssd_scan(x, dt, a_neg, bm, cm, chunk=32, state0=s0,
                     use_kernel=False)
    (y.float().sum() + st.sum()).backward()
    assert k.grad is not None and bool(torch.isfinite(k.grad).all())
    assert dt.grad is not None and bool(torch.isfinite(dt.grad).all())


def test_ssd_scan_plain_version_not_called_on_cuda(cuda):
    args = _ssd_inputs(cuda, 1, 64, 4, 32, 32, 1, torch.float32, True)
    before = ref.ssd_chunked.calls
    ssd_scan(*args[:5], chunk=32, state0=args[5])
    torch.cuda.synchronize()
    assert ref.ssd_chunked.calls == before
    ssd_scan(*args[:5], chunk=32, state0=args[5], use_kernel=False)
    assert ref.ssd_chunked.calls == before + 1


# The blocked form of K3's plain version (the train path's attention past
# Sq.Sk = 2048^2) against the direct form on CUDA tensors in f32, at a
# ragged last block (S 2,100) and whole blocks (S 4,096): the output at
# F32_TOL, dq, dk and dv at rtol 1e-5 plus 1e-5 of their largest
# (``tests/test_torch_train.py``'s gradient tolerance).  (H, KH, Dqk, Dv,
# window, causal): qwen's layers, recurrentgemma's local layers, MLA's
# widths, and non-causal with a window over the padded keys
BLOCKED_CASES = [(16, 16, 64, 64, None, True), (16, 1, 256, 256, 2048, True),
                 (4, 2, 192, 128, None, True), (4, 2, 64, 64, 1500, False)]


@pytest.mark.parametrize("s", [2100, 4096])
@pytest.mark.parametrize("h,kh,dqk,dv,window,causal", BLOCKED_CASES)
def test_blocked_form_matches_direct_form_on_cuda(cuda, s, h, kh, dqk, dv,
                                                  window, causal):
    gen = torch.Generator(device=cuda).manual_seed(s + h + dqk)
    q, k, v, cot = (torch.randn(shape, generator=gen, device=cuda)
                    for shape in ((1, s, h, dqk), (1, s, kh, dqk),
                                  (1, s, kh, dv), (1, s, h, dv)))
    pos = torch.arange(s, device=cuda)
    outs, grads = [], []
    for form in (ref.grouped_attention, ref.grouped_attention_blocked):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = form(*leaves, pos, pos, causal=causal, window=window)
        grads.append(torch.autograd.grad((out * cot).sum(), leaves))
        outs.append(out.detach())
    np.testing.assert_allclose(outs[1].cpu().numpy(), outs[0].cpu().numpy(),
                               **F32_TOL)
    for name, got, want in zip("qkv", grads[1], grads[0]):
        assert got.dtype == torch.float32 and got.shape == want.shape
        want = want.cpu().numpy()
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_attention_past_2048_squared_is_the_blocked_form_on_cuda(
        cuda, dtype):
    """``use_kernel=False`` on CUDA tensors past 2048^2: one plain call, no
    launch, bitwise the blocked form."""
    q, k, v = _qkv(cuda, 1, 2100, 2100, 4, 2, 64, dtype)
    pos = torch.arange(2100, device=cuda)
    launches, calls = flash_attention.launches, ref.attention_ref.calls
    got = flash_attention(q, k, v, window=300, use_kernel=False)
    assert flash_attention.launches == launches
    assert ref.attention_ref.calls == calls + 1
    want = ref.grouped_attention_blocked(q, k, v, pos, pos, causal=True,
                                         window=300)
    assert got.dtype == dtype and torch.equal(got, want)
