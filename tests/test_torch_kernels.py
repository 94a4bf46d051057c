"""The port's kernel modules on the CPU against the reference.

The port's plain K1 and K2 (``repro_torch.kernels.ref``, reached through
the ``ops`` dispatch on CPU tensors) against ``repro.kernels.ref`` and
against the Pallas kernels run in interpret mode (``ops.ota_round_step``,
``ops.ota_aggregate`` with ``interpret=True``), per cell, on the same
numpy-seeded inputs; the uplink quantizer bit for bit; and the pytree
wrappers and ``core.ota`` against theirs, with the noise replayed from
the reference's own per-leaf keying.

Tolerances: f32 outputs 2e-5 rel/abs, the reference's own kernel
tolerance (both sides accumulate in f32, in another order); a bf16 output
is compared in f32 at 6e-2 (one bf16 ulp after a reordered f32 sum).  The
CUDA kernels themselves are held against the plain versions on the card
(``test_torch_kernels_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ota as jota
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import ota as tota
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ota_aggregate as toa
from repro_torch.kernels import ref as tref
from repro_torch.kernels import round_step as trs
from torch_ref import one_thread  # noqa: F401 (autouse)

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=6e-2, atol=6e-2)
SWEEP = [(c, n, d) for c in (1, 3) for n in (1, 10) for d in (128, 5000)]


def _bf16_exact(a: np.ndarray) -> np.ndarray:
    """Round f32 values to bf16-representable f32 (what both sides see)."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _inputs(c, n, d, seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((c, n, d)).astype(np.float32)
    s = rng.uniform(0, 0.2, (c, n)).astype(np.float32)
    s[:, -1] = 0.0                                  # a truncated device
    z = rng.standard_normal((c, d)).astype(np.float32)
    p = rng.standard_normal((c, d)).astype(np.float32)
    ns = _bf16_exact(rng.uniform(0.01, 0.1, (c,)).astype(np.float32))
    eta = rng.uniform(0.01, 0.1, (c,)).astype(np.float32)
    return g, s, z, p, ns, eta


def _jnp_wire(wire: torch.Tensor):
    if wire.dtype == torch.bfloat16:
        return jnp.asarray(wire.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(wire.numpy())


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("c,n,d", SWEEP)
def test_plain_round_step_matches_reference_and_pallas(c, n, d, wire):
    g, s, z, p, ns, eta = _inputs(c, n, d, seed=c * 100 + n * 10 + d)
    w, qs = tops.quantize_uplink(torch.from_numpy(g), wire)
    got = tops.ota_round_step_flat(w, *_t(s, z, ns, p, eta), qs).numpy()
    assert got.shape == (c, d) and got.dtype == np.float32
    for ci in range(c):
        wj = _jnp_wire(w[ci])
        qj = None if qs is None else jnp.asarray(qs[ci].numpy())
        args = (wj, jnp.asarray(s[ci]), jnp.asarray(z[ci]),
                jnp.asarray(ns[ci]), jnp.asarray(p[ci]), jnp.asarray(eta[ci]))
        want = jref.ota_round_step_ref(*args, q_scale=qj)
        pallas = jops.ota_round_step(*args, qj, interpret=True)
        np.testing.assert_allclose(got[ci], np.asarray(want), **F32_TOL)
        np.testing.assert_allclose(got[ci], np.asarray(pallas), **F32_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,n,d", SWEEP)
def test_plain_aggregate_matches_reference_and_pallas(c, n, d, dtype):
    g, s, z, _, ns, _ = _inputs(c, n, d, seed=7 + c * 100 + n * 10 + d)
    gt = torch.from_numpy(g).to(dtype)
    got = tops.ota_aggregate_flat(gt, *_t(s, z, ns))
    assert got.shape == (c, d) and got.dtype == dtype
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for ci in range(c):
        gj = _jnp_wire(gt[ci])
        args = (gj, jnp.asarray(s[ci]), jnp.asarray(z[ci]))
        want = jref.ota_aggregate_ref(*args, jnp.asarray(ns[ci], gj.dtype))
        pallas = jops.ota_aggregate(*args, jnp.float32(ns[ci]),
                                    interpret=True)
        for ref_out in (want, pallas):
            np.testing.assert_allclose(got[ci].float().numpy(),
                                       np.asarray(ref_out, np.float32), **tol)


def _np_round_step(g, qs, s, z, ns, p, eta):
    """K1's arithmetic in numpy float32: one rounded op at a time, devices
    in order."""
    acc = np.zeros(z.shape, np.float32)
    for m in range(g.shape[1]):
        gm = g[:, m]
        if qs is not None:
            gm = gm * qs[:, m, None]
        acc = acc + gm * s[:, m, None]
    return p - eta[:, None] * (acc + ns[:, None] * z)


def _np_bf16(a: np.ndarray) -> np.ndarray:
    """Round f32 to bf16 (to nearest, ties to even), kept as f32 values."""
    u = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("c,n,d", SWEEP + [(2, 32, 37), (7, 10, 15)])
def test_plain_round_step_is_kernel_arithmetic(c, n, d, wire):
    """The plain K1 equals a numpy float32 loop in K1's association, bit
    for bit, so the card can hold the kernel to it with torch.equal."""
    g, s, z, p, ns, eta = _inputs(c, n, d, seed=5 + c * 100 + n * 10 + d)
    w, qs = tops.quantize_uplink(torch.from_numpy(g), wire)
    got = tref.ota_round_step_ref(w, *_t(s, z, ns, p, eta), q_scale=qs)
    want = _np_round_step(w.float().numpy(),
                          None if qs is None else qs.numpy(), s, z, ns, p, eta)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("c,n,d", SWEEP)
def test_plain_round_step_unit_scale_is_exact(c, n, d):
    """The kernel always multiplies by a dequantization scale (ones for an
    f32 or bf16 wire); the plain version skips it: x * 1 is exact."""
    g, s, z, p, ns, eta = _t(*_inputs(c, n, d, seed=9))
    a = tref.ota_round_step_ref(g, s, z, ns, p, eta)
    b = tref.ota_round_step_ref(g, s, z, ns, p, eta,
                                q_scale=torch.ones_like(s))
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,n,d", SWEEP + [(2, 32, 37), (7, 10, 15)])
def test_plain_aggregate_is_kernel_arithmetic(c, n, d, dtype):
    """The plain K2 equals a numpy float32 loop in K2's association (one
    cast on write), bit for bit."""
    g, s, z, _, ns, _ = _inputs(c, n, d, seed=6 + c * 100 + n * 10 + d)
    gt = torch.from_numpy(g).to(dtype)
    got = tref.ota_aggregate_ref(gt, *_t(s, z, ns))
    acc = np.zeros((c, d), np.float32)
    gf = gt.float().numpy()
    for m in range(n):
        acc = acc + gf[:, m] * s[:, m, None]
    want = acc + ns[:, None] * z
    if dtype == torch.bfloat16:
        want = _np_bf16(want)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("wire", ["bf16", "int8"])
@pytest.mark.parametrize("c,n,d", SWEEP)
def test_quantize_uplink_bitwise(c, n, d, wire):
    g = _inputs(c, n, d, seed=3)[0] * np.float32(1e-3)
    g[0, 0, :] = 0.0                               # an all-zero device
    g[-1, -1, : min(d, 4)] = [0.5, -0.5, 1.5, 2.5][: min(d, 4)]  # ties
    w, qs = tops.quantize_uplink(torch.from_numpy(g), wire)
    for ci in range(c):
        wj, qj = jops.quantize_uplink(jnp.asarray(g[ci]), wire)
        np.testing.assert_array_equal(w[ci].float().numpy(),
                                      np.asarray(wj, np.float32))
        if wire == "int8":
            # an all-zero device's scale is f32.tiny/127, a denormal that
            # XLA's CPU flushes to zero and PyTorch keeps; its codes and its
            # dequantized row are 0 on both sides, every other scale is equal
            live = np.abs(g[ci]).max(axis=1) > 0
            assert w.dtype == torch.int8
            np.testing.assert_array_equal(qs[ci].numpy()[live],
                                          np.asarray(qj)[live])
            np.testing.assert_array_equal(
                tops.dequantize_uplink(w, qs)[ci].numpy(),
                np.asarray(jops.dequantize_uplink(wj, qj)))
    if wire == "int8":
        assert int(w.abs().max()) <= 127


def test_f32_uplink_is_passthrough():
    g = torch.randn(2, 3, 5)
    w, qs = tops.quantize_uplink(g, "f32")
    assert w is g and qs is None
    with pytest.raises(ValueError):
        tops.quantize_uplink(g, "fp8")


def _grad_tree(c, n, seed):
    rng = np.random.default_rng(seed)
    shapes = {"w1": (6, 4), "b1": (4,), "w2": (4, 3), "b2": (3,)}
    grads = {k: rng.standard_normal((c, n) + v).astype(np.float32)
             for k, v in shapes.items()}
    params = {k: rng.standard_normal((c,) + v).astype(np.float32)
              for k, v in shapes.items()}
    return grads, params


def _noise(key, tree):
    """The reference's per-leaf noise keying, raveled in leaf order."""
    leaves = jax.tree.leaves(tree)
    keys = jax.random.split(key, len(leaves))
    return np.concatenate([np.asarray(jax.random.normal(k, (l.size,)))
                           for k, l in zip(keys, leaves)])


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
def test_round_step_pytree_matches_reference(wire):
    c, n = 2, 5
    grads, params = _grad_tree(c, n, seed=11)
    rng = np.random.default_rng(12)
    s = rng.uniform(0, 0.3, (c, n)).astype(np.float32)
    ns = np.float32([0.05, 0.0])
    eta = np.float32([0.06, 0.08])
    keys = jax.random.split(jax.random.PRNGKey(5), c)
    z = np.stack([_noise(keys[ci], {k: v[ci] for k, v in params.items()})
                  for ci in range(c)])
    got = tops.ota_round_step_pytree(
        {k: torch.from_numpy(v) for k, v in grads.items()}, *_t(s, ns, z),
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(eta), uplink_dtype=wire)
    for ci in range(c):
        want = jops.ota_round_step_pytree(
            {k: jnp.asarray(v[ci]) for k, v in grads.items()},
            jnp.asarray(s[ci]), jnp.float32(ns[ci]), keys[ci],
            {k: jnp.asarray(v[ci]) for k, v in params.items()},
            jnp.float32(eta[ci]), uplink_dtype=wire, use_kernel=False)
        for k in params:
            assert got[k].shape == params[k].shape
            np.testing.assert_allclose(got[k][ci].numpy(),
                                       np.asarray(want[k]), **F32_TOL)


@pytest.mark.parametrize("wire", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("flat", [True, False])
def test_apply_round_coeffs_matches_reference(wire, flat):
    if wire != "f32" and not flat:
        with pytest.raises(ValueError):
            tota.apply_round_coeffs({}, None, None, None, flat=False,
                                    uplink_dtype=wire)
        return
    c, n = 3, 4
    grads, params = _grad_tree(c, n, seed=21)
    s = np.random.default_rng(22).uniform(0, 0.3, (c, n)).astype(np.float32)
    ns = np.float32([0.02, 0.0, 0.3])
    keys = jax.random.split(jax.random.PRNGKey(9), c)
    z = np.stack([_noise(keys[ci], {k: v[ci] for k, v in params.items()})
                  for ci in range(c)])
    got = tota.apply_round_coeffs(
        {k: torch.from_numpy(v) for k, v in grads.items()}, *_t(s, ns, z),
        flat=flat, uplink_dtype=wire)
    for ci in range(c):
        want = jota.apply_round_coeffs(
            {k: jnp.asarray(v[ci]) for k, v in grads.items()},
            jnp.asarray(s[ci]), jnp.float32(ns[ci]), keys[ci], flat=flat,
            uplink_dtype=wire)
        for k in grads:
            assert got[k].shape == params[k].shape
            np.testing.assert_allclose(got[k][ci].numpy(),
                                       np.asarray(want[k]), **F32_TOL)


def test_weighted_sum_matches_reference():
    grads, _ = _grad_tree(2, 6, seed=31)
    s = np.random.default_rng(32).uniform(0, 1, (2, 6)).astype(np.float32)
    got = tota.weighted_sum({k: torch.from_numpy(v) for k, v in grads.items()},
                            torch.from_numpy(s))
    for ci in range(2):
        want = jota.weighted_sum({k: jnp.asarray(v[ci])
                                  for k, v in grads.items()},
                                 jnp.asarray(s[ci]))
        for k in grads:
            np.testing.assert_allclose(got[k][ci].numpy(),
                                       np.asarray(want[k]), **F32_TOL)


def test_cpu_tensors_take_the_plain_version():
    g, s, z, p, ns, eta = _t(*_inputs(2, 3, 50, seed=0))
    before = (tref.ota_round_step_ref.calls, tref.ota_aggregate_ref.calls,
              trs.ota_round_step.launches, toa.ota_aggregate.launches)
    tops.ota_round_step_flat(g, s, z, ns, p, eta)
    tops.ota_aggregate_flat(g, s, z, ns)
    after = (tref.ota_round_step_ref.calls, tref.ota_aggregate_ref.calls,
             trs.ota_round_step.launches, toa.ota_aggregate.launches)
    assert after == (before[0] + 1, before[1] + 1, before[2], before[3])
    with pytest.raises(ValueError, match="CUDA"):
        tops.ota_round_step_flat(g, s, z, ns, p, eta, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        trs.ota_round_step(g, torch.ones_like(s), s, z, ns, p, eta)
    with pytest.raises(ValueError, match="CUDA"):
        toa.ota_aggregate(g, s, z, ns)
