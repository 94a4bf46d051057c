"""The port's cifar_conv task against the reference's.

* ``cifar_like``, ``partition_dirichlet`` and ``stack_shards(pad=True)``
  are numpy copies: bitwise the reference's (values and dtypes), across
  alpha, seeds and the repair of starved devices.
* The convnet (``models/conv.py``) against ``repro.models.conv`` on the
  reference's own weights carried across with ``params_from_jax``:
  logits and loss at rtol 2e-5 / atol 1e-6, per-device gradients at rtol
  2e-5 plus 1e-5 of each leaf's largest magnitude (the same f32 math;
  PyTorch's CPU convolution and XLA's sum in another order, so they agree
  to ~1e-6 relative, not bitwise; a gradient element that sums to near
  zero keeps the absolute error of its leaf's large terms).
* The task's data (``build_data``) bitwise the reference task's.
* A [2 scheme x 2 seed] cifar fleet at the smoke widths (channels (8, 16),
  hidden 32, 20 samples per class), minibatch 8 on the flat, fused path,
  on the reference's replayed draws, against
  ``repro.fl.driver.run_fleet_task`` in a child process at rtol 1e-4 /
  atol 1e-5 over 4 rounds on the traces and evals (accumulated f32
  rounding, as tests/test_torch_fleet.py), and on the params at rtol 1e-4
  / atol 5e-5: a ReLU input within f32 rounding of zero (1.3e-9 in
  round 1 of the ideal scheme's seed-1 cell, on device 3's minibatch)
  switches its unit on one side and off on the other, and that cell's
  convolution weights and biases then move apart by up to 1.3e-5 over
  the remaining rounds while every other cell stays within 1e-7; and its
  kill and resume bitwise.
"""
import jax
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

import torch_ref
from repro.data import partition as jpart, synthetic as jsyn
from repro.models import conv as jconv
from repro.models.param import init_params as jinit
from repro.tasks.image import make_cifar_conv as jmake_cifar
from repro_torch import tasks
from repro_torch.core import power_control as tpc
from repro_torch.data import partition as tpart, synthetic as tsyn
from repro_torch.fl import driver as tdriver
from repro_torch.fl.draws import ReplayDraws
from repro_torch.models import conv as tconv
from repro_torch.models.param import params_from_jax
from torch_ref import one_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
MODEL_TOL = dict(rtol=2e-5, atol=1e-6)
FLEET_TOL = dict(rtol=1e-4, atol=1e-5)
PARAMS_TOL = dict(rtol=1e-4, atol=5e-5)      # the ReLU kink, see above
ROUNDS, EVERY, BATCH, SEEDS = 4, 2, 8, (0, 1)


def _eq(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


@pytest.mark.parametrize("spc,noise,seed,test", [(20, 0.25, 0, 10),
                                                  (7, 0.5, 3, 4)])
def test_cifar_like_bitwise(spc, noise, seed, test):
    got = tsyn.cifar_like(spc, noise=noise, seed=seed, test_per_class=test)
    _eq(got, jsyn.cifar_like(spc, noise=noise, seed=seed,
                             test_per_class=test))
    assert got[0].shape == (10 * spc,) + tsyn.CIFAR_SHAPE


@pytest.mark.parametrize("alpha,seed,min_per", [
    (0.05, 0, 3), (0.3, 0, 1), (0.3, 1, 1), (1.0, 2, 1), (5.0, 0, 1),
    (0.1, 4, 5)])
def test_partition_dirichlet_and_padded_stack_bitwise(alpha, seed, min_per):
    x, y, _, _ = jsyn.cifar_like(12, seed=seed, test_per_class=1)
    t = tpart.partition_dirichlet(x, y, 10, alpha=alpha, seed=seed,
                                  min_per_device=min_per)
    j = jpart.partition_dirichlet(x, y, 10, alpha=alpha, seed=seed,
                                  min_per_device=min_per)
    _eq(t, j)
    assert sum(len(s[1]) for s in t) == len(y)
    assert min(len(s[1]) for s in t) >= min_per
    for pad in (True, False):
        _eq(tpart.stack_shards(t, pad=pad), jpart.stack_shards(j, pad=pad))
    xs, ys = tpart.stack_shards(t, pad=True)
    assert xs.shape[1] == max(len(s[1]) for s in t)


def test_partition_dirichlet_refusals():
    x, y, _, _ = jsyn.cifar_like(2, seed=0, test_per_class=1)
    with pytest.raises(ValueError, match="alpha"):
        tpart.partition_dirichlet(x, y, 10, alpha=0.0)
    with pytest.raises(ValueError, match="not enough samples"):
        tpart.partition_dirichlet(x, y, 10, alpha=0.3, min_per_device=3)


@pytest.mark.parametrize("channels,hidden", [((16, 32), 128), ((8, 16), 32)])
def test_conv_defs_match_reference(channels, hidden):
    t = tconv.conv_defs(channels, hidden)
    j = jconv.conv_defs(channels, hidden)
    assert sorted(t) == sorted(j)
    for k in t:
        assert t[k].shape == j[k].shape and t[k].init == j[k].init
        assert t[k].fan_in == j[k].fan_in
    assert tconv.conv_dim(channels, hidden) == jconv.conv_dim(channels,
                                                              hidden)
    assert tconv.conv_dim() == 268_650


def _weights(channels, hidden, seed):
    p = jinit(jconv.conv_defs(channels, hidden), jax.random.PRNGKey(seed))
    return p, params_from_jax({k: np.asarray(v) for k, v in p.items()})


def _images(n, b, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, b, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, (n, b)).astype(np.int32)
    return x, y


@pytest.mark.parametrize("channels,hidden,seed", [((16, 32), 128, 0),
                                                  ((8, 16), 32, 1)])
def test_conv_forward_loss_accuracy_match(channels, hidden, seed):
    jp, tp = _weights(channels, hidden, seed)
    x, y = _images(1, 16, seed)
    xt, yt = torch.from_numpy(x[0]), torch.from_numpy(y[0]).long()
    np.testing.assert_allclose(
        tconv.conv_forward(tp, xt).numpy(),
        np.asarray(jconv.conv_forward(jp, x[0])), **MODEL_TOL)
    np.testing.assert_allclose(
        float(tconv.conv_loss(tp, (xt, yt))),
        float(jconv.conv_loss(jp, (x[0], y[0]))), **MODEL_TOL)
    assert float(tconv.accuracy(tp, xt, yt)) \
        == float(jconv.accuracy(jp, x[0], y[0]))


def test_flatten_is_nhwc_order():
    """``w1``'s rows follow the reference's (h, w, c) flatten: a weight
    that reads one pooled channel at one spatial site picks exactly that
    activation."""
    _, tp = _weights((8, 16), 32, 2)
    x, _ = _images(1, 2, 2)
    xt = torch.from_numpy(x[0])
    h = tconv._conv_relu_pool(xt.permute(0, 3, 1, 2), tp["conv1"],
                              tp["bc1"])
    h = tconv._conv_relu_pool(h, tp["conv2"], tp["bc2"])   # [B, 16, 8, 8]
    row = (3 * 8 + 5) * 16 + 7                  # (h 3, w 5, c 7)
    w1 = torch.zeros_like(tp["w1"])
    w1[row, 0] = 1.0
    probe = dict(tp, w1=w1, b1=torch.zeros_like(tp["b1"]),
                 w2=torch.eye(32, 10), b2=torch.zeros(10))
    got = tconv.conv_forward(probe, xt)[:, 0]
    assert torch.equal(got, torch.relu(h[:, 7, 3, 5]))


def test_per_device_gradients_match():
    jp, tp = _weights((8, 16), 32, 3)
    x, y = _images(3, 4, 3)
    jg = jax.vmap(jax.grad(jconv.conv_loss), in_axes=(None, (0, 0)))(
        jp, (x, y))
    tg = vmap(grad(tconv.conv_loss), in_dims=(None, (0, 0)))(
        tp, (torch.from_numpy(x), torch.from_numpy(y).long()))
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   rtol=MODEL_TOL["rtol"],
                                   atol=1e-5 * float(np.abs(jg[k]).max()),
                                   err_msg=k)


def test_task_data_bitwise_reference():
    t = tasks.get("cifar_conv", **torch_ref.CIFAR_SMOKE_KW)
    j = jmake_cifar(**torch_ref.CIFAR_SMOKE_KW)
    assert t.param_dim == j.param_dim and t.artifact_tag == j.artifact_tag
    assert t.defaults == j.defaults and t.scheme_etas == j.scheme_etas
    for seed in (0, 1):
        a, b = t.build_data(seed), j.build_data(seed)
        _eq(a.train, b.train)
        _eq(a.test, b.test)
        _eq(a.extras["global"], b.extras["global"])


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return torch_ref.run_reference_telemetry(
        tmp_path_factory.mktemp("cifar"), rounds=ROUNDS, every=EVERY,
        batch=BATCH, seeds=SEEDS, telemetry=False)


def _port_run(ref, **kw):
    task = tasks.get("cifar_conv", **torch_ref.CIFAR_SMOKE_KW)
    schemes = [tpc.scheme_from_jax(n, torch_ref.prefixed(ref, f"scheme/{n}"))
               for n in torch_ref.TEL_SCHEMES]
    draws = ReplayDraws(ref["draws/h"], ref["draws/z"], ref["draws/idx"],
                        ref["draws/coin"], CPU)
    run = task.run_config(num_rounds=ROUNDS, eval_every=EVERY, seed=0,
                          batch_size=BATCH)
    params0 = params_from_jax(torch_ref.prefixed(ref, "params0"))
    return tdriver.run_fleet_task(task, schemes, ref["gains"], run,
                                  params=params0, seeds=SEEDS, flat=True,
                                  draws=draws, device="cpu", **kw)


def test_cifar_fleet_matches_reference(ref):
    res = _port_run(ref)
    assert res.names == torch_ref.TEL_SCHEMES and res.seeds == SEEDS
    want = torch_ref.prefixed(ref, "cifar/params")
    assert sorted(res.params) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(res.params[k].numpy(), v, **PARAMS_TOL,
                                   err_msg=k)
    want = {k: v for k, v in torch_ref.prefixed(ref, "cifar/traces").items()
            if not k.startswith("bv_")}
    assert set(res.traces) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(res.traces[k], v, **FLEET_TOL, err_msg=k)
    assert [t for t, _ in res.evals] == list(ref["cifar/evals_t"])
    for k, v in torch_ref.prefixed(ref, "cifar/evals").items():
        np.testing.assert_allclose(np.stack([ev[k] for _, ev in res.evals]),
                                   v, **FLEET_TOL, err_msg=k)


def test_cifar_fleet_kill_and_resume_bitwise(ref, tmp_path):
    whole = _port_run(ref)
    path = str(tmp_path / "fleet")
    first = _port_run(ref, checkpoint_path=path, max_chunks=1)
    rest = _port_run(ref, checkpoint_path=path, resume=True)
    assert sum(n for n, _ in first.chunk_walls) < ROUNDS
    for k in whole.params:
        assert torch.equal(whole.params[k], rest.params[k]), k
    assert set(whole.traces) == set(rest.traces)
    for k in whole.traces:
        assert np.array_equal(whole.traces[k], rest.traces[k]), k
    assert [t for t, _ in whole.evals] == [t for t, _ in rest.evals]
    for (_, a), (_, b) in zip(whole.evals, rest.evals):
        for k in a:
            assert np.array_equal(a[k], b[k]), k
