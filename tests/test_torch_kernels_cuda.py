"""The port's CUDA kernels K1 and K2 against their plain PyTorch versions
on the card.

Needs an NVIDIA GPU and nvcc; every test skips without a CUDA device.
This file imports no JAX, so it also runs on a machine with the card and
no JAX installed:

    python -m pytest -q --noconftest tests/test_torch_kernels_cuda.py

Tolerances: f32 accumulation on both sides, in another order, so f32
outputs agree to 2e-5 (the reference's own kernel tolerance); a bf16
output may land one bf16 ulp apart after that, so bf16 is compared in f32
at 6e-2 (as the reference's bf16 kernel sweeps).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ota_aggregate, ref, round_step

pytestmark = pytest.mark.cuda

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=6e-2, atol=6e-2)
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
