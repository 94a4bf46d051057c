"""The port's paper MLP, its loss, per-device clipped gradients and the
clipping itself, against the reference on params carried across with
``params_from_jax``.

Tolerance 2e-5 rel / 1e-6 abs (loss, logits, gradients): the same f32
math, with the matmul and reduction sums taken in another order by XLA
and PyTorch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from repro.models import mlp as jmlp
from repro.models.param import init_params as jinit
from repro.optim.optimizers import clip_by_global_norm as jclip
from repro_torch.models import mlp as tmlp
from repro_torch.models.param import (init_params, param_count,
                                      params_from_jax)
from repro_torch.optim.optimizers import clip_by_global_norm as tclip

TOL = dict(rtol=2e-5, atol=1e-6)


def _jparams(hidden, seed=0):
    p = jinit(jmlp.mlp_defs(hidden=hidden), jax.random.PRNGKey(seed))
    return p, params_from_jax({k: np.asarray(v) for k, v in p.items()})


def _batch(n, b, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, b, 784)).astype(np.float32)
    y = rng.integers(0, 10, (n, b)).astype(np.int32)
    return x, y


def test_params_from_jax_is_exact_and_ordered():
    jp, tp = _jparams(16)
    assert list(tp) == ["b1", "b2", "w1", "w2"]
    for k in jp:
        assert tp[k].dtype == torch.float32
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))


@pytest.mark.parametrize("hidden", [16, 64])
def test_forward_loss_accuracy_match(hidden):
    jp, tp = _jparams(hidden, seed=hidden)
    x, y = _batch(1, 32, seed=hidden)
    x, y = x[0], y[0]
    np.testing.assert_allclose(
        tmlp.mlp_forward(tp, torch.from_numpy(x)).numpy(),
        np.asarray(jmlp.mlp_forward(jp, jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(
        float(tmlp.mlp_loss(tp, (torch.from_numpy(x),
                                 torch.from_numpy(y).long()))),
        float(jmlp.mlp_loss(jp, (jnp.asarray(x), jnp.asarray(y)))), **TOL)
    assert float(tmlp.accuracy(tp, torch.from_numpy(x),
                               torch.from_numpy(y).long())) == \
        float(jmlp.accuracy(jp, jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize("gmax", [10.0, 0.05])
def test_per_device_clipped_grads_match(gmax):
    """vmap(grad) over devices, then the global-norm clip, as the round
    body does; gmax=0.05 makes every device clip."""
    jp, tp = _jparams(16, seed=3)
    x, y = _batch(4, 8, seed=3)

    def jdev(b):
        return jclip(jax.grad(jmlp.mlp_loss)(jp, b), gmax)
    jg, jn = jax.vmap(jdev)((jnp.asarray(x), jnp.asarray(y)))

    def tdev(xb, yb):
        return tclip(grad(tmlp.mlp_loss)(tp, (xb, yb)), gmax)
    tg, tn = vmap(tdev)(torch.from_numpy(x), torch.from_numpy(y).long())
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), **TOL)
    for k in jg:
        assert tg[k].shape == (4,) + tuple(jp[k].shape)
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), **TOL)
    if gmax < 1:
        sq = sum(torch.sum(tg[k] ** 2, dim=tuple(range(1, tg[k].dim())))
                 for k in tg)
        np.testing.assert_allclose(torch.sqrt(sq).numpy(), gmax, rtol=1e-5)


def test_init_law():
    defs = tmlp.mlp_defs(hidden=256)
    assert param_count(tmlp.mlp_defs()) == tmlp.PARAM_DIM == 814_090
    p = init_params(defs, 0, torch.device("cpu"))
    assert list(p) == ["b1", "b2", "w1", "w2"]
    assert not p["b1"].any() and not p["b2"].any()
    assert abs(float(p["w1"].std()) * np.sqrt(784) - 1) < 0.02
    assert abs(float(p["w2"].std()) * np.sqrt(256) - 1) < 0.1
    q = init_params(defs, 0, torch.device("cpu"))
    assert all(torch.equal(p[k], q[k]) for k in p)
    assert not torch.equal(p["w1"],
                           init_params(defs, 1, torch.device("cpu"))["w1"])
