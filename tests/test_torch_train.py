"""The port's LM train path on the CPU against the reference.

Module by module: the token stream and its client shards (bitwise), the
optimizers and schedules on random trees, the loss weights, the
cross-entropy and the LM loss, and the gradients of the plain attention
and SSD scan against ``jax.grad`` of the reference's ``grouped_attention``
and ``ssd_chunked`` (the train path differentiates them; K3 and K4 have
no backward).  Then the whole step: the port's ``make_train_step`` and
``make_ideal_train_step`` against the reference's
``repro.launch.steps`` in a child process (``torch_ref._TRAIN_CHILD``: its
import chain reaches ``repro.solvers``, which needs the ``enable_x64``
shim), on smoke configs of qwen1.5-0.5b, mamba2-1.3b and
recurrentgemma-9b in f32, from the reference's weights carried across
with ``lm_params_from_jax``, on its tokens, fading, coin and per-leaf
noise replayed (the noise of a stacked ``scan`` leaf sliced per layer by
the same mapping).  Then the checkpoint
in the reference's stacked layout, both ways, and ``launch.train`` end to
end on the CPU.

Tolerances: the step's loss and params after one step at rtol 1e-5 /
atol 1e-6 (the same f32 math, sums taken in another order); after four
steps at rtol 1e-4 / atol 1e-5, as ``test_torch_fleet.py`` holds
trajectories.  Gradients at rtol 1e-5 plus 1e-5 of their largest
magnitude (an entry sums many products; one that cancels to near zero
keeps only that absolute part).
The optimizers and schedules at 1e-6.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ref
from repro import configs as jconfigs
from repro.checkpoint import checkpoint as jckpt
from repro.core import ota as jota
from repro.data import synthetic as jsynthetic
from repro.models import attention as jattn
from repro.models import ssm as jssm
from repro.models import transformer as jtfm
from repro.models.registry import build_bundle as jbuild
from repro.optim import optimizers as joptim
from repro.optim import schedules as jsched
from repro.tasks import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch import tasks
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.core import ota as tota
from repro_torch.core.power_control import scheme_from_jax
from repro_torch.data import synthetic as tsynthetic
from repro_torch.fl import driver
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as ttfm
from repro_torch.models.param import (encdec_params_from_jax,
                                      encdec_params_to_stacked,
                                      lm_params_from_jax,
                                      lm_params_to_stacked, map_named,
                                      param_leaves, trainable)
from repro_torch.models.registry import build_bundle as tbuild
from repro_torch.optim import optimizers as toptim
from repro_torch.optim import schedules as tsched
from repro_torch.tasks import lm as tlm

CPU = torch.device("cpu")
STEP1_TOL = dict(rtol=1e-5, atol=1e-6)
STEP4_TOL = dict(rtol=1e-4, atol=1e-5)
# a gradient entry sums many products: rtol 1e-5, plus 1e-5 of the
# gradient's largest magnitude for entries that cancel to near zero
GRAD_RTOL, GRAD_ATOL_SHARE = 1e-5, 1e-5
OPT_TOL = dict(rtol=1e-6, atol=1e-6)
CASES = {c["name"]: c for c in torch_ref.TRAIN_CASES}


def _np(x):
    return np.asarray(x.detach().float().numpy() if torch.is_tensor(x)
                      else x, np.float32)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# data, optimizers, schedules, weights, loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,vocab,seed", [(1, 7, 0), (1000, 512, 3),
                                          (20_000, 8192, 1001)])
def test_token_stream_matches_reference_bitwise(n, vocab, seed):
    got = tsynthetic.token_stream(n, vocab, seed=seed)
    want = jsynthetic.token_stream(n, vocab, seed=seed)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("vocab,clients,per_client,seq,steps,seed", [
    (512, 4, 1, 32, 3, 0), (8192, 4, 2, 128, 2, 3), (1000, 3, 1, 7, 5, 1)])
def test_client_batches_match_reference_bitwise(vocab, clients, per_client,
                                                seq, steps, seed):
    got = tlm.client_batches(vocab, clients, per_client, seq, steps, seed)
    want = jlm.client_batches(vocab, clients, per_client, seq, steps, seed)
    assert got.shape == (steps, clients, per_client, seq + 1)
    np.testing.assert_array_equal(got, want)


def test_task_build_data_splits_the_held_out_step():
    task = tasks.get("token_stream", expect_runtime="steps", device="cpu")
    td = task.build_data(3, steps=5)
    assert task.aux["cfg"].vocab_size == 8192     # the factory's smoke vocab
    want = jlm.client_batches(8192, 4, 1, 32, 6, 3)
    np.testing.assert_array_equal(td.train, want[:5])
    np.testing.assert_array_equal(td.test, want[-1].reshape(-1, 33))
    assert td.extras == {"steps": 5} and task.runtime == "steps"
    assert task.param_dim == task.aux["bundle"].num_params


def _tree(seed, dtypes=("f32", "f32", "bf16")):
    shapes = {"a": (3, 5), "b": (7,), "c": (2, 3, 4)}
    return {k: _rand(shape, seed + i)
            for i, (k, shape) in enumerate(shapes.items())}, \
        dict(zip(shapes, dtypes))


def _as(tree, dtypes, torch_side):
    if torch_side:
        return {k: torch.from_numpy(v).to(torch.bfloat16 if dtypes[k] == "bf16"
                                          else torch.float32)
                for k, v in tree.items()}
    return {k: jnp.asarray(v, jnp.bfloat16 if dtypes[k] == "bf16"
                           else jnp.float32) for k, v in tree.items()}


@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("sgd_momentum", {"beta": 0.8}),
    ("adamw", {}), ("adamw", {"weight_decay": 0.1, "b2": 0.99})])
def test_optimizers_match_reference(name, kw):
    """Three updates on a random tree with a bf16 leaf, the second at an
    explicit learning rate: params (cast back to their dtype) and the f32
    state."""
    params, dtypes = _tree(0)
    tp, jp = _as(params, dtypes, True), _as(params, dtypes, False)
    topt, jopt = (toptim.get_optimizer(name, 0.05, **kw),
                  joptim.get_optimizer(name, 0.05, **kw))
    ts, js = topt.init(tp), jopt.init(jp)
    for i, lr in enumerate((None, 0.01, None)):
        grads, _ = _tree(10 + i)
        tp, ts = topt.update(_as(grads, dtypes, True), ts, tp, lr)
        jp, js = jopt.update(_as(grads, dtypes, False), js, jp, lr)
    for k in params:
        assert tp[k].dtype == (torch.bfloat16 if dtypes[k] == "bf16"
                               else torch.float32)
        np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k], np.float32),
                                   **OPT_TOL)
    t_state = [] if name == "sgd" else (
        [ts] if name == "sgd_momentum" else [ts.mu, ts.nu])
    j_state = [] if name == "sgd" else (
        [js] if name == "sgd_momentum" else [js.mu, js.nu])
    for t, j in zip(t_state, j_state):
        for k in params:
            assert t[k].dtype == torch.float32
            np.testing.assert_allclose(_np(t[k]), np.asarray(j[k]),
                                       **OPT_TOL)
    if name == "adamw":
        assert int(ts.count) == int(js.count) == 3


def test_clip_and_unknown_optimizer():
    with pytest.raises(ValueError, match="unknown optimizer"):
        toptim.get_optimizer("lion", 0.1)
    grads, _ = _tree(3, ("f32",) * 3)
    got, norm = toptim.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in grads.items()}, 1.0)
    want, jnorm = joptim.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in grads.items()}, 1.0)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    for k in grads:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   **OPT_TOL)


@pytest.mark.parametrize("make", [
    lambda m: m.constant(0.03),
    lambda m: m.warmup_cosine(0.1, 10, 100),
    lambda m: m.warmup_cosine(0.1, 0, 50, floor=0.2)])
def test_schedules_match_reference(make):
    t, j = make(tsched), make(jsched)
    for step in (0, 1, 5, 10, 11, 37, 99, 100, 150):
        got = t(step)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(j(step)), rtol=1e-6,
                                   atol=1e-9)


def test_per_client_loss_weights_match_reference():
    s = np.array([0.0, 0.3, 1.7, 2.5e-3], np.float32)
    got = tota.per_client_loss_weights(torch.from_numpy(s))
    np.testing.assert_array_equal(_np(got), np.asarray(
        jota.per_client_loss_weights(jnp.asarray(s))))


def test_add_receiver_noise_leaves_in_the_leaf_dtype():
    """g + (noise_scale * z) cast to the leaf's dtype, per leaf: an f32 and
    a bf16 leaf against the reference's arithmetic."""
    g = {"a": torch.from_numpy(_rand((4, 3), 0)),
         "b": torch.from_numpy(_rand((5,), 1)).to(torch.bfloat16)}
    z = {"a": torch.from_numpy(_rand((4, 3), 2)),
         "b": torch.from_numpy(_rand((5,), 3))}
    ns = torch.tensor(0.37)
    got = tota.add_receiver_noise_leaves(g, ns, z)
    for k, dt in (("a", jnp.float32), ("b", jnp.bfloat16)):
        gj = jnp.asarray(_np(g[k]), dt)
        want = gj + (jnp.float32(0.37) * jnp.asarray(_np(z[k]))).astype(dt)
        assert got[k].dtype == g[k].dtype
        np.testing.assert_array_equal(_np(got[k]),
                                      np.asarray(want, np.float32))


@pytest.mark.parametrize("weights", [False, True])
def test_softmax_xent_matches_reference(weights):
    logits = 3 * _rand((3, 6, 40), 0)
    labels = np.random.default_rng(1).integers(0, 40, (3, 6))
    labels[0, 2] = labels[2, :] = -1            # masked, and a whole row
    w = np.array([0.5, 2.0, 1.3], np.float32) if weights else None
    got = ttfm.softmax_xent(torch.from_numpy(logits),
                            torch.from_numpy(labels), 40,
                            None if w is None else torch.from_numpy(w))
    want = jtfm.softmax_xent(jnp.asarray(logits), jnp.asarray(labels), 40,
                             None if w is None else jnp.asarray(w))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _smoke(arch, **kw):
    return (jconfigs.get_config(arch).smoke(**kw),
            tconfigs.get_config(arch).smoke(**kw))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-1.3b"])
def test_lm_loss_and_its_gradient_match_reference(arch):
    """The loss with per-sample weights, and its gradient through the
    whole model (the plain attention or SSD scan), leaf by leaf in the
    reference's stacked layout."""
    jcfg, tcfg = _smoke(arch)
    jp = jbuild(jcfg, tp=1, dp=1).init(jax.random.PRNGKey(1))
    tp = lm_params_from_jax(tcfg, jax.tree.map(np.asarray, jp))
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (4, 34))
    w = np.array([0.0, 1.5, 2.0, 0.5], np.float32)
    jloss, jgrad = jax.value_and_grad(jtfm.lm_loss)(
        jp, jnp.asarray(toks), jcfg, sample_weights=jnp.asarray(w))
    view, leaves = trainable(tp)
    loss = ttfm.lm_loss(view, torch.from_numpy(toks), tcfg,
                        sample_weights=torch.from_numpy(w))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               **STEP1_TOL)
    by_name = dict(zip(leaves, grads))
    got = tckpt._flatten(lm_params_to_stacked(
        tcfg, map_named(tp, lambda name, _: by_name[name])))
    want = jckpt._flatten(jgrad)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the plain kernels' gradients against jax.grad of the reference's forms
# ---------------------------------------------------------------------------

def _close_grad(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(_np(got), want, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL_SHARE * np.abs(want).max(),
                               err_msg=name)


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("h,kh", [(4, 4), (4, 2)])
def test_attention_gradient_matches_reference(h, kh, window):
    q, k, v = _rand((2, 19, h, 64), 0), _rand((2, 19, kh, 64), 1), \
        _rand((2, 19, kh, 64), 2)
    cot = _rand((2, 19, h, 64), 3)
    pos = jnp.arange(19)

    def jf(q, k, v):
        o = jattn.grouped_attention(q, k, v, pos, pos, causal=True,
                                    window=window)
        return jnp.sum(o * cot)
    want = jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    calls = tref.attention_ref.calls
    out = flash_attention(tq, tk, tv, causal=True, window=window)
    assert tref.attention_ref.calls == calls + 1   # the CPU route: plain
    got = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                              (tq, tk, tv))
    for name, g, w in zip("qkv", got, want):
        _close_grad(g, w, name)


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_gradient_matches_reference(g):
    """x, dt, a_neg, B, C and state0 against jax.grad of the reference's
    ``ssd_chunked`` (L 64, chunk 32), through y and the final state."""
    b, l, h, p, n = 2, 64, 4, 32, 32
    rng = np.random.default_rng(4)
    x = _rand((b, l, h, p), 5)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    a_neg = -np.exp(0.5 * rng.standard_normal(h)).astype(np.float32)
    bm, cm = 0.5 * _rand((b, l, g, n), 6), 0.5 * _rand((b, l, g, n), 7)
    s0 = _rand((b, h, p, n), 8)
    cy, cs = _rand((b, l, h, p), 9), _rand((b, h, p, n), 10)
    args = (x, dt, a_neg, bm, cm, s0)

    def jf(x, dt, a_neg, bm, cm, s0):
        y, st = jssm.ssd_chunked(x, dt, a_neg, bm, cm, 32, state0=s0)
        return jnp.sum(y * cy) + jnp.sum(st * cs)
    want = jax.grad(jf, argnums=tuple(range(6)))(*map(jnp.asarray, args))
    tt = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, st = ssd_scan(*tt[:5], chunk=32, state0=tt[5])
    got = torch.autograd.grad((y * torch.from_numpy(cy)).sum()
                              + (st * torch.from_numpy(cs)).sum(), tt)
    for name, gt, w in zip(("x", "dt", "a_neg", "b", "c", "state0"), got,
                           want):
        _close_grad(gt, w, name)


# ---------------------------------------------------------------------------
# the train step against the reference's, on replayed draws
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_train(tmp_path_factory):
    return torch_ref.run_reference_train(
        tmp_path_factory.mktemp("train") / "train.npz")


def _nested(blob, prefix):
    return tckpt._nest(torch_ref.prefixed(blob, prefix))


def _from_jax(cfg, tree):
    return (encdec_params_from_jax if cfg.is_enc_dec
            else lm_params_from_jax)(cfg, tree)


def _to_stacked(cfg, params):
    return (encdec_params_to_stacked if cfg.is_enc_dec
            else lm_params_to_stacked)(cfg, params)


@functools.lru_cache(maxsize=None)
def _port_run(name, ideal, ref_id):
    """The port's run of case ``name`` on the reference's replayed draws:
    (metrics per step, {step: params flattened in the stacked layout})."""
    ref, c = _REF[ref_id], CASES[name]
    tcfg = tconfigs.get_config(c["arch"]).smoke(**c["smoke"])
    bundle = tbuild(tcfg, CPU)
    params = _from_jax(tcfg, _nested(ref, f"{name}/params0"))
    tc = tsteps.TrainStepConfig(eta=c["eta"])
    if ideal:
        step = tsteps.make_ideal_train_step(bundle, tc)
    else:
        scheme = scheme_from_jax(c["scheme"],
                                 torch_ref.prefixed(ref, f"{name}/scheme"))
        step = tsteps.make_train_step(bundle, scheme, ref[f"{name}/gains"],
                                      tc)
    data = ref[f"{name}/data"]
    frames = torch_ref.case_frames(c, tcfg.d_model) if tcfg.is_enc_dec \
        else None
    metrics, snaps = [], {}
    for t in range(c["steps"]):
        batch = torch.from_numpy(data[t].reshape(-1, c["seq"] + 1)).long()
        if frames is not None:
            batch = (torch.from_numpy(frames[t]), batch)
        draws = None if ideal else tsteps.StepDraws(
            h=torch.from_numpy(ref[f"{name}/h/{t}"]).to(torch.complex64),
            coin=torch.tensor(bool(ref[f"{name}/coin/{t}"])),
            z=param_leaves(_from_jax(      # f32 smoke configs
                tcfg, _nested(ref, f"{name}/z/{t}"))))
        params, m = step(params, batch, draws)
        metrics.append({k: float(v) for k, v in m.items()})
        # copies: the step updates the params in place, and a CPU
        # tensor's numpy view would follow
        snaps[t] = {k: v.copy() for k, v in tckpt._flatten(
            _to_stacked(tcfg, params)).items()}
    return metrics, snaps


_REF = {}


def _run(ref, name, ideal=False):
    _REF[id(ref)] = ref
    return _port_run(name, ideal, id(ref))


def _check_params(got, ref, prefix, tol):
    want = torch_ref.prefixed(ref, prefix)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **tol, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_train_step_one_step_matches_reference(ref_train, name):
    metrics, snaps = _run(ref_train, name)
    np.testing.assert_allclose(metrics[0]["loss"],
                               ref_train[f"{name}/loss"][0], **STEP1_TOL)
    assert metrics[0]["active_clients"] \
        == ref_train[f"{name}/active_clients"][0]
    np.testing.assert_allclose(metrics[0]["noise_scale"],
                               ref_train[f"{name}/noise_scale"][0],
                               rtol=1e-6)
    _check_params(snaps[0], ref_train, f"{name}/params/0", STEP1_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_train_step_four_steps_match_reference(ref_train, name):
    c = CASES[name]
    metrics, snaps = _run(ref_train, name)
    last = c["steps"] - 1
    np.testing.assert_allclose([m["loss"] for m in metrics],
                               ref_train[f"{name}/loss"], **STEP4_TOL)
    assert [m["active_clients"] for m in metrics] \
        == list(ref_train[f"{name}/active_clients"])
    _check_params(snaps[last], ref_train, f"{name}/params/{last}",
                  STEP4_TOL)
    if name == "bbfl":       # the coin fell both ways over the run
        assert {bool(ref_train[f"{name}/coin/{t}"])
                for t in range(c["steps"])} == {False, True}


@pytest.mark.parametrize("name", ["qwen", "mamba2", "seamless"])
def test_ideal_train_step_matches_reference(ref_train, name):
    metrics, snaps = _run(ref_train, name, ideal=True)
    last = CASES[name]["steps"] - 1
    np.testing.assert_allclose(metrics[0]["loss"],
                               ref_train[f"{name}/ideal_loss"][0],
                               **STEP1_TOL)
    _check_params(snaps[0], ref_train, f"{name}/ideal_params/0", STEP1_TOL)
    np.testing.assert_allclose([m["loss"] for m in metrics],
                               ref_train[f"{name}/ideal_loss"], **STEP4_TOL)
    _check_params(snaps[last], ref_train, f"{name}/ideal_params/{last}",
                  STEP4_TOL)


@pytest.mark.parametrize("ideal", [False, True])
def test_train_step_refuses_frames_of_another_batch(ideal):
    """(frames, tokens) whose batch axes differ raise before the loss."""
    tcfg = tconfigs.get_config("seamless-m4t-medium").smoke()
    bundle = tbuild(tcfg, CPU)
    tc = tsteps.TrainStepConfig()
    design = ttrain.make_design("vanilla", 2, bundle.num_params)
    gains = design.prm.gains
    step = tsteps.make_ideal_train_step(bundle, tc) if ideal else \
        tsteps.make_train_step(bundle, design.pc, gains, tc)
    tokens = torch.zeros((2, 9), dtype=torch.long)
    frames = torch.zeros((4, 8, tcfg.d_model))
    draws = tsteps.DeviceStepDraws(0, gains, {}, CPU)(0)
    with pytest.raises(ValueError, match="batch axis"):
        step(bundle.init(0), (frames, tokens), draws)


def test_train_step_refuses_other_optimizers():
    _, tcfg = _smoke("qwen1.5-0.5b")
    bundle = tbuild(tcfg, CPU)
    with pytest.raises(ValueError, match="SGD"):
        tsteps.make_ideal_train_step(
            bundle, tsteps.TrainStepConfig(optimizer="adamw"))


def test_device_step_draws_are_keyed_per_seed_and_step():
    shapes = {"a": (3, 4), "b": (5,)}
    gains = np.array([1.0, 0.25, 4.0], np.float32)
    d0 = tsteps.DeviceStepDraws(1, gains, shapes, CPU)
    a, b = d0(3), d0(7)
    again = tsteps.DeviceStepDraws(1, gains, shapes, CPU)(3)
    other = tsteps.DeviceStepDraws(2, gains, shapes, CPU)(3)
    assert torch.equal(a.h, again.h) and torch.equal(a.z["a"], again.z["a"])
    assert not torch.equal(a.h, b.h) and not torch.equal(a.h, other.h)
    assert a.h.dtype == torch.complex64 and a.h.shape == (3,)
    assert a.coin.dtype == torch.bool and a.coin.shape == ()
    assert {k: tuple(v.shape) for k, v in a.z.items()} == shapes
    assert all(v.dtype == torch.float32 for v in a.z.values())


# ---------------------------------------------------------------------------
# the checkpoint in the reference's stacked layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kw", [
    ("qwen1.5-0.5b", dict(n_layers=3)),
    ("mamba2-1.3b", {}),
    ("recurrentgemma-9b", dict(n_layers=4)),
    ("recurrentgemma-9b", dict(n_layers=4, param_dtype=torch.bfloat16,
                               compute_dtype=torch.bfloat16)),
    ("qwen3-1.7b", dict(param_dtype=torch.bfloat16,
                        compute_dtype=torch.bfloat16)),
    ("mixtral-8x22b", dict(n_layers=3, moe_first_dense=1)),
    ("seamless-m4t-medium", {}),
    ("seamless-m4t-medium", dict(n_layers=3, param_dtype=torch.bfloat16,
                                 compute_dtype=torch.bfloat16))])
def test_checkpoint_round_trips_through_the_reference_layout(tmp_path, arch,
                                                             kw):
    """The port's archive restores in the reference's ``restore`` bitwise
    into its own param tree, and the reference's archive restores in the
    port's ``restore_lm`` bitwise (bf16 leaves written as f32 and cast
    back)."""
    tcfg = tconfigs.get_config(arch).smoke(**kw)
    jkw = {k: (jnp.bfloat16 if v == torch.bfloat16 else v)
           for k, v in kw.items()}
    jcfg = jconfigs.get_config(arch).smoke(**jkw)
    params = tbuild(tcfg, CPU).init(3)
    path = str(tmp_path / "port.npz")
    tckpt.save_lm(path, tcfg, params, meta={"arch": tcfg.name})
    like = jbuild(jcfg, tp=1, dp=1).init(jax.random.PRNGKey(0))
    restored = jckpt.restore(path, like)
    want = tckpt._flatten(_widened(_to_stacked(tcfg, params)))
    got = jckpt._flatten(restored)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.asarray(jckpt._flatten(like)[k]).dtype
        np.testing.assert_array_equal(np.asarray(got[k], np.float32),
                                      want[k], err_msg=k)
    assert tckpt.load_meta(path) == {"arch": tcfg.name}
    # and back: the reference's archive into the port
    jpath = str(tmp_path / "ref.npz")
    jckpt.save(jpath, restored)
    back = tckpt.restore_lm(jpath, tcfg)
    for (n1, a), (n2, b) in zip(param_leaves(params).items(),
                                param_leaves(back).items()):
        assert n1 == n2 and a.dtype == b.dtype
        assert torch.equal(a, b), n1


def _widened(tree):
    if isinstance(tree, dict):
        return {k: _widened(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_widened(v) for v in tree]
    return tree.float()


def test_stacked_layout_inverts_lm_params_from_jax():
    """lm_params_to_stacked(lm_params_from_jax(tree)) is the reference's
    tree, leaf for leaf (a hybrid of two layer kinds, stacked per unit)."""
    kw = dict(arch_type="hybrid", block_pattern=("attn", "ssd"))
    jcfg = jconfigs.get_config("qwen3-1.7b").replace(**kw).smoke(n_layers=5)
    tcfg = tconfigs.get_config("qwen3-1.7b").replace(**kw).smoke(n_layers=5)
    jp = jax.tree.map(np.asarray, jbuild(jcfg, tp=1, dp=1).init(
        jax.random.PRNGKey(0)))
    back = tckpt._flatten(lm_params_to_stacked(
        tcfg, lm_params_from_jax(tcfg, jp)))
    want = jckpt._flatten(jp)
    assert sorted(back) == sorted(want)
    assert any(k.startswith("tail/0/") for k in want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


@pytest.mark.parametrize("kw", [{}, dict(n_layers=3)])
def test_stacked_layout_inverts_encdec_params_from_jax(kw):
    """encdec_params_to_stacked(encdec_params_from_jax(tree)) is the
    reference's ``encdec_defs`` tree, leaf for leaf."""
    jcfg = jconfigs.get_config("seamless-m4t-medium").smoke(**kw)
    tcfg = tconfigs.get_config("seamless-m4t-medium").smoke(**kw)
    jp = jax.tree.map(np.asarray, jbuild(jcfg, tp=1, dp=1).init(
        jax.random.PRNGKey(0)))
    back = tckpt._flatten(encdec_params_to_stacked(
        tcfg, encdec_params_from_jax(tcfg, jp)))
    want = jckpt._flatten(jp)
    assert sorted(back) == sorted(want)
    assert want["dec_scan/u0/cross/wq/w"].shape[0] == tcfg.n_layers
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# the registry and the entry point
# ---------------------------------------------------------------------------

def test_fleet_consumers_refuse_the_lm_task():
    task = tasks.get("token_stream", device="cpu")
    with pytest.raises(ValueError, match="steps"):
        driver.run_fleet_task(task, [], np.ones(4), device="cpu")
    with pytest.raises(ValueError, match="'steps'-runtime"):
        tasks.get("token_stream", expect_runtime="fleet")


def test_train_entry_point_on_the_cpu(capsys, tmp_path):
    path = str(tmp_path / "ckpt.npz")
    before = (flash_attention.launches, ssd_scan.launches,
              tref.attention_ref.calls)
    res = ttrain.main(["--smoke", "--device", "cpu", "--steps", "6",
                       "--log-every", "2", "--checkpoint", path])
    out = capsys.readouterr().out
    lines = out.strip().splitlines()
    assert lines[0].startswith("arch=qwen1.5-0.5b params=")
    assert "participation p:" in out and "step    0 loss" in out
    assert lines[-2].startswith("final_loss=") and "held_out_loss=" \
        in lines[-2] and "improved=" in lines[-2]
    assert (flash_attention.launches, ssd_scan.launches) == before[:2]
    # 6 train steps and the eval, 2 layers each: the plain attention
    assert tref.attention_ref.calls == before[2] + 7 * 2
    assert len(res.losses) == 6 and all(np.isfinite(res.losses))
    assert np.isfinite(res.held_out)
    st = res.stats
    assert st["k3_launches_eval"] == st["k4_launches_eval"] == 0
    assert st["card"] is None and st["step_ms"] > 0
    back = tckpt.restore_lm(path, res.task.aux["cfg"])
    for a, b in zip(param_leaves(res.params).values(),
                    param_leaves(back).values()):
        assert torch.equal(a, b)


def test_train_run_takes_a_design_made_for_its_world(capsys):
    """A design made beforehand for the run's world is the run's own
    design, and the run trains as it would (at the one-step tolerance: two
    CPU runs of the same step may round an ulp apart, as the CPU's
    reductions can follow where a tensor was allocated); one made for
    another world, or scheme, is refused."""
    kw = dict(smoke=True, device="cpu", steps=2, scheme="lcpc")
    res = ttrain.run(**kw)
    d = res.task.param_dim
    design = ttrain.make_design("lcpc", 4, d)
    assert ttrain.same_world(ttrain.design_of(kw, "cpu").prm, design.prm)
    given = ttrain.run(**kw, design=design)
    assert given.scheme is design.pc
    for f in ("gamma", "alpha", "p", "thresholds"):
        np.testing.assert_array_equal(getattr(design.pc, f),
                                      getattr(res.scheme, f))
    np.testing.assert_allclose(given.losses + [given.held_out],
                               res.losses + [res.held_out], **STEP1_TOL)
    for a, b in zip(param_leaves(given.params).values(),
                    param_leaves(res.params).values()):
        np.testing.assert_allclose(_np(a), _np(b), **STEP1_TOL)
    for bad in (ttrain.make_design("lcpc", 4, d + 1),
                ttrain.make_design("lcpc", 4, d, eta=0.05),
                ttrain.make_design("lcpc", 4, d, seed=1),
                ttrain.make_design("vanilla", 4, d)):
        with pytest.raises(ValueError, match="another world"):
            ttrain.run(**kw, design=bad)


def test_train_entry_point_mamba2_on_the_cpu(capsys):
    res = ttrain.main(["--arch", "mamba2-1.3b", "--smoke", "--device", "cpu",
                       "--steps", "3", "--seq", "40"])
    assert len(res.losses) == 3 and all(np.isfinite(res.losses))
    assert res.stats["arch"] == "mamba2-1.3b"


@pytest.mark.parametrize("name", ["paper_mlp", "nope"])
def test_train_cli_refuses_other_tasks(name):
    with pytest.raises(SystemExit, match=name):
        ttrain.main(["--task", name, "--device", "cpu"])


def test_train_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(["--smoke", "--steps", "1"])
