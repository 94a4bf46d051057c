"""The port's RG-LRU block (``repro_torch.models.rglru``) on the CPU
against the reference's ``repro.models.rglru``.

The same numpy-seeded inputs go through both: the gates, the recurrence
(the port's doubling scan against the reference's ``associative_scan``,
with and without a carried state, S up to 1,024), and the block's
prefill, recurrent decode and prefill from a state, whose conv window the
reference zero-pads (the port keeps that quirk; ROADMAP.md §3).  The
reference initializes the biases to 0 and ``lam`` to 1; the tests
perturb them with seeded noise, the same on both sides.

Tolerances: the scan at rtol 1e-5 / atol 1e-6 (the same f32 products,
combined in another order: log-depth in both, but not the same tree);
the gates and the block at rtol 1e-4 / atol 1e-5, the serve slice's
tolerance (``tests/test_torch_lm.py``): their products of width W and D
are summed in another order by XLA and PyTorch.  A bf16 model's output at
rtol / atol 2e-2, a few bf16 ulps: both sides round the linears' outputs
to bf16, and an ulp's difference there passes through the f32 gates.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import rglru as jrglru
from repro.models.param import init_params as jinit
from repro_torch import configs as tconfigs
from repro_torch.models import rglru as trglru
from repro_torch.models.param import ParamTree, tree_param_count
from torch_ref import one_thread  # noqa: F401 (autouse)

SCAN_TOL = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-5)
CPU = torch.device("cpu")


def _cfgs(**kw):
    return (jconfigs.get_config("recurrentgemma-9b").smoke(**kw),
            tconfigs.get_config("recurrentgemma-9b").smoke(**kw))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(x):
    return np.asarray(x.detach().float().numpy() if torch.is_tensor(x)
                      else x, np.float32)


def _params(jcfg, seed=0):
    """The reference's init, with seeded noise on its biases and ``lam``,
    as numpy; and the same as a ParamTree."""
    p = jinit(jrglru.rglru_def(jcfg, tp=1), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    jp = {}
    for k, a in p.items():
        a = np.asarray(a, np.float32)
        if k in ("b_a", "b_x", "conv_b", "lam"):
            a = a + 0.5 * rng.standard_normal(a.shape).astype(np.float32)
        jp[k] = a
    return jp, ParamTree({k: torch.from_numpy(a.copy())
                          for k, a in jp.items()})


def _state(b, w, seed):
    return {"h": _rand((b, w), seed), "conv": _rand((b, 3, w), seed + 1)}


def test_rglru_def_matches_reference():
    """Every leaf's shape, dtype and init law; lam float32 in a bf16
    model."""
    kw = dict(param_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16)
    jcfg = jconfigs.get_config("recurrentgemma-9b").smoke(**kw)
    tcfg = tconfigs.get_config("recurrentgemma-9b").smoke(
        param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    jdefs, tdefs = jrglru.rglru_def(jcfg, tp=1), trglru.rglru_def(tcfg)
    assert sorted(jdefs) == sorted(tdefs)
    for k, jd in jdefs.items():
        td = tdefs[k]
        assert td.shape == jd.shape and td.init == jd.init, k
        assert td.fan_in == jd.fan_in, k
        assert td.dtype == (torch.float32 if k == "lam" else torch.bfloat16)
        assert str(jnp.dtype(jd.dtype)) == ("float32" if k == "lam"
                                            else "bfloat16")
    assert tree_param_count(tdefs) == sum(int(np.prod(d.shape))
                                          for d in jdefs.values())
    for name, jst in jrglru.init_rglru_state(jcfg, 3).items():
        tst = trglru.init_rglru_state(tcfg, 3, CPU)[name]
        assert tuple(tst.shape) == jst.shape and tst.dtype == torch.float32


def test_gates_match_reference():
    jcfg, _ = _cfgs()
    jp, tp = _params(jcfg)
    x = _rand((2, 9, trglru._width(jcfg)), 1)
    want = jrglru._gates(jp, jnp.asarray(x))
    got = trglru._gates(tp, torch.from_numpy(x))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_np(g), _np(w), **TOL)


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("s", [1, 2, 3, 7, 64, 100, 1000, 1024])
def test_lru_scan_matches_reference(s, h0):
    """The doubling scan against ``associative_scan``: log_a over the
    block's range (8 r log sigmoid(lam), r in (0, 1)), unit-normal gated
    inputs, a unit-normal h0 or none."""
    rng = np.random.default_rng(s)
    w = 32
    r = rng.uniform(0, 1, (2, s, w)).astype(np.float32)
    lam = rng.standard_normal(w).astype(np.float32)
    log_a = (8.0 * r * np.log(1 / (1 + np.exp(-lam)))).astype(np.float32)
    gated = rng.standard_normal((2, s, w)).astype(np.float32)
    init = rng.standard_normal((2, w)).astype(np.float32) if h0 else None
    want = jrglru._lru_scan(jnp.asarray(log_a), jnp.asarray(gated),
                            None if init is None else jnp.asarray(init))
    got = trglru._lru_scan(torch.from_numpy(log_a), torch.from_numpy(gated),
                           None if init is None else torch.from_numpy(init))
    assert got.shape == (2, s, w) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **SCAN_TOL)


def test_lru_scan_is_the_recurrence():
    """The scan against the recurrence written out, step by step, in f64."""
    rng = np.random.default_rng(7)
    log_a = -rng.uniform(0, 2, (1, 77, 8))
    gated = rng.standard_normal((1, 77, 8))
    h0 = rng.standard_normal((1, 8))
    h, want = h0, []
    for t in range(77):
        a = np.exp(log_a[:, t])
        h = a * h + np.sqrt(np.maximum(1 - a * a, 1e-12)) * gated[:, t]
        want.append(h)
    got = trglru._lru_scan(*map(torch.from_numpy, (log_a, gated, h0)))
    np.testing.assert_allclose(got.numpy(), np.stack(want, 1), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rglru_prefill_matches_reference(dtype):
    """A prefill without a state (the train forward), in f32 and in a bf16
    model (the gates and the recurrence stay f32)."""
    if dtype == "bf16":
        jcfg, _ = _cfgs(param_dtype=jnp.bfloat16,
                        compute_dtype=jnp.bfloat16)
        _, tcfg = _cfgs(param_dtype=torch.bfloat16,
                        compute_dtype=torch.bfloat16)
        tol = dict(rtol=2e-2, atol=2e-2)
    else:
        (jcfg, tcfg), tol = _cfgs(), TOL
    jp, tp = _params(jcfg)
    x = _rand((2, 37, jcfg.d_model), 2)
    want, st = jrglru.rglru_apply(
        {k: jnp.asarray(a, jcfg.param_dtype if k != "lam" else jnp.float32)
         for k, a in jp.items()}, jnp.asarray(x), jcfg)
    assert st is None
    got, tst = trglru.rglru_apply(
        {k: v.to(tcfg.param_dtype if k != "lam" else torch.float32)
         for k, v in tp.state_dict().items()}, torch.from_numpy(x), tcfg)
    assert tst is None and got.dtype == tcfg.compute_dtype
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_rglru_prefill_and_decode_match_reference():
    """A prefill of 37 rows from the zero state, then 4 decode steps: the
    outputs and both parts of the state, written in place."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    w, s, steps = trglru._width(jcfg), 37, 4
    x = _rand((2, s + steps, jcfg.d_model), 3)
    jst = jrglru.init_rglru_state(jcfg, 2)
    tst = trglru.init_rglru_state(tcfg, 2, CPU)
    want, jst = jrglru.rglru_apply(jp, jnp.asarray(x[:, :s]), jcfg,
                                   state=jst)
    got, out = trglru.rglru_apply(tp, torch.from_numpy(x[:, :s]), tcfg,
                                  state=tst)
    assert out is tst                                   # in place
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for i in range(steps):
        for n in ("h", "conv"):
            assert tst[n].shape == jst[n].shape and jst[n].shape[-1] == w
            np.testing.assert_allclose(_np(tst[n]), _np(jst[n]), **TOL)
        xs = x[:, s + i:s + i + 1]
        want, jst = jrglru.rglru_apply(jp, jnp.asarray(xs), jcfg, state=jst,
                                       decode=True)
        got, _ = trglru.rglru_apply(tp, torch.from_numpy(xs), tcfg,
                                    state=tst, decode=True)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_rglru_prefill_from_a_state_matches_reference():
    """A prefill from a nonzero state: the recurrence starts from h, the
    conv window is zero-padded (the reference ignores state["conv"] there),
    and the new state holds the last h and the branch's last 3 rows."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    w = trglru._width(jcfg)
    x = _rand((2, 11, jcfg.d_model), 4)
    init = _state(2, w, 5)
    want, jst = jrglru.rglru_apply(
        jp, jnp.asarray(x), jcfg,
        state={k: jnp.asarray(a) for k, a in init.items()})
    tst = {k: torch.from_numpy(a.copy()) for k, a in init.items()}
    got, _ = trglru.rglru_apply(tp, torch.from_numpy(x), tcfg, state=tst)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for n in ("h", "conv"):
        np.testing.assert_allclose(_np(tst[n]), _np(jst[n]), **TOL)
    # the quirk: the carried conv window changes nothing
    other = {"h": torch.from_numpy(init["h"].copy()),
             "conv": torch.zeros(2, 3, w)}
    again, _ = trglru.rglru_apply(tp, torch.from_numpy(x), tcfg, state=other)
    assert torch.equal(again, got)


def test_rglru_prefill_shorter_than_the_conv_window_raises():
    _, tcfg = _cfgs()
    _, tp = _params(_cfgs()[0])
    state = trglru.init_rglru_state(tcfg, 1, CPU)
    with pytest.raises(ValueError, match="conv window"):
        trglru.rglru_apply(tp, torch.zeros(1, trglru.CONV_K - 2,
                                           tcfg.d_model), tcfg, state=state)
    out, _ = trglru.rglru_apply(tp, torch.zeros(1, 2, tcfg.d_model), tcfg)
    assert out.shape == (1, 2, tcfg.d_model)        # no state: any length
