"""The port's MoE FFN (``repro_torch.models.moe``) and the MoE decoder's
loss and train step on the CPU against the reference's ``repro.models.moe``
and ``repro.models.transformer``.

The same numpy-seeded inputs go through both: the expert capacity and the
dispatch indices (bitwise: slots and drops, on cases with and without
overflow), the router (``route``), the experts fed the reference's own
routes (``experts``), ``moe_apply`` on mixtral's smoke config, with
``capacity_factor=0.5`` (tokens dropped), with a shared expert and with
k = E, then the LM loss with the router's aux term and its gradient
against ``jax.grad``, one OTA-FL train step on the reference's replayed
draws (``torch_ref.run_reference_train`` in a child process, as
``test_torch_train.py``), and the stacked layout of a model with a dense
lead layer (its checkpoint rides ``test_torch_train.py``'s round trip).

Tolerances: float32 throughout.  The router's probabilities and weights
at rtol 1e-5 / atol 1e-7 and its expert choices equal (the logits are one
product of width D, summed in another order); the aux loss at rtol 1e-6;
the experts' output at rtol 1e-5 / atol 1e-6 (two products of width D and
F, summed in another order by XLA and PyTorch), a bf16 layer at 2e-2 (a
few bf16 ulps); the loss at rtol 1e-5 / atol 1e-6 and its gradients at
rtol 1e-4 / atol 1e-6, as ``test_torch_train.py``; the train step at its
one-step tolerance, rtol 1e-5 / atol 1e-6, after each of two steps.  The
serve slice (prefill and decode) is ``test_torch_lm.py``'s, at its
tolerance.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ref
from repro import configs as jconfigs
from repro.checkpoint import checkpoint as jckpt
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.models.param import init_params as jinit
from repro.models.registry import build_bundle as jbuild
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.core.power_control import scheme_from_jax
from repro_torch.launch import steps as tsteps
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.models.param import (ParamDef, ParamTree, _init_one,
                                      layer_groups, lm_params_from_jax,
                                      lm_params_to_stacked, map_named,
                                      param_leaves, trainable)
from repro_torch.models.registry import build_bundle as tbuild

CPU = torch.device("cpu")
ROUTE_TOL = dict(rtol=1e-5, atol=1e-7)
AUX_RTOL = 1e-6
EXPERT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
STEP1_TOL = dict(rtol=1e-5, atol=1e-6)
# smoke overrides of mixtral-8x22b (4 experts, top 2, expert width 128)
MOE_CASES = {
    "mixtral": {},
    "cf05": dict(capacity_factor=0.5),
    "shared": dict(moe_shared_experts=1),
    "k_eq_e": dict(moe_top_k=4),
}


def _cfgs(**kw):
    return (jconfigs.get_config("mixtral-8x22b").smoke(**kw),
            tconfigs.get_config("mixtral-8x22b").smoke(**kw))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _np(x):
    return np.asarray(x.detach().float().numpy() if torch.is_tensor(x)
                      else x, np.float32)


def _moe_params(jcfg, seed=0):
    """The reference's ``moe_def`` init as numpy, and as a ParamTree."""
    jp = jax.tree.map(lambda a: np.asarray(a, np.float32),
                      jinit(jmoe.moe_def(jcfg, tp=1, dp=1),
                            jax.random.PRNGKey(seed)))
    return jp, ParamTree(jax.tree.map(torch.from_numpy, jp))


def _ref_route(jp, x, jcfg):
    """The reference's router lines (``moe_apply``'s first half)."""
    logits = jnp.einsum("bsd,de->bse", jnp.asarray(x),
                        jnp.asarray(jp["router"]))
    probs = jax.nn.softmax(logits, axis=-1)
    top_w, top_e = jax.lax.top_k(probs, jcfg.moe_top_k)
    return probs, top_w / jnp.sum(top_w, axis=-1, keepdims=True), top_e


# ---------------------------------------------------------------------------
# capacity and dispatch indices, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [1, 7, 37, 1024, 8192])
@pytest.mark.parametrize("kw", [dict(), dict(capacity_factor=0.5),
                                dict(moe_num_experts=8),
                                dict(moe_num_experts=256, moe_top_k=8)])
def test_expert_capacity_matches_reference(seq, kw):
    jcfg, tcfg = (c.replace(**kw) for c in (jconfigs.get_config(
        "mixtral-8x22b"), tconfigs.get_config("mixtral-8x22b")))
    assert tmoe.expert_capacity(tcfg, seq) == jmoe.expert_capacity(jcfg, seq)


def test_expert_capacity_at_mixtral_shapes():
    """Per batch row: 320 slots at the prefill's S 1,024; 4 at a decode
    step (S = 1)."""
    cfg = tconfigs.get_config("mixtral-8x22b")
    assert tmoe.expert_capacity(cfg, 1024) == 320
    assert tmoe.expert_capacity(cfg, 1) == 4


@pytest.mark.parametrize("case", [
    ("no overflow", 12, 4, 8, 0),
    ("overflow", 40, 4, 4, 1),
    ("one expert takes all", 23, 3, 4, 2),
    ("capacity 1", 16, 8, 1, 3),
    ("deepseek-like", 512, 256, 4, 4),
], ids=lambda c: c[0])
def test_dispatch_indices_match_reference_bitwise(case):
    _, a, e, cap, seed = case
    rng = np.random.default_rng(seed)
    eid = rng.integers(0, e, a) if case[0] != "one expert takes all" \
        else np.full(a, 1)
    want_slot, want_keep = jmoe._dispatch_indices(
        jnp.asarray(eid, jnp.int32), cap, e)
    slot, keep = tmoe._dispatch_indices(torch.from_numpy(eid), cap, e)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(want_slot))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want_keep))
    assert (not keep.all()) == (np.bincount(eid, minlength=e).max() > cap)


def test_dispatch_indices_take_rows_on_their_own():
    """A [B, A] input ranks each row alone, as the reference's vmap."""
    eid = np.random.default_rng(5).integers(0, 4, (3, 30))
    slot, keep = tmoe._dispatch_indices(torch.from_numpy(eid), 5, 4)
    for r in range(3):
        ws, wk = jmoe._dispatch_indices(jnp.asarray(eid[r], jnp.int32), 5, 4)
        np.testing.assert_array_equal(slot[r].numpy(), np.asarray(ws))
        np.testing.assert_array_equal(keep[r].numpy(), np.asarray(wk))


# ---------------------------------------------------------------------------
# route, experts, moe_apply
# ---------------------------------------------------------------------------

def test_route_matches_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _moe_params(jcfg)
    x = _rand((3, 29, jcfg.d_model), 1)
    probs, top_w, top_e, aux = tmoe.route(tp, torch.from_numpy(x), tcfg)
    wprobs, wtop_w, wtop_e = _ref_route(jp, x, jcfg)
    np.testing.assert_allclose(_np(probs), _np(wprobs), **ROUTE_TOL)
    np.testing.assert_allclose(_np(top_w), _np(wtop_w), **ROUTE_TOL)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(wtop_e))
    _, waux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(float(aux), float(waux), rtol=AUX_RTOL)


def test_route_breaks_ties_toward_the_lower_expert():
    """Equal probabilities: the lower expert first, as ``lax.top_k``."""
    _, tcfg = _cfgs()
    tp = {"router": torch.zeros(tcfg.d_model, tcfg.moe_num_experts)}
    _, top_w, top_e, _ = tmoe.route(tp, torch.ones(1, 3, tcfg.d_model), tcfg)
    assert top_e.tolist() == [[[0, 1]] * 3]
    assert torch.equal(top_w, torch.full((1, 3, 2), 0.5))


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_experts_on_the_reference_routes_match_reference(name):
    """``experts`` handed the reference's own top_e and top_w: the slots
    and drops bitwise the reference's ``_dispatch_indices`` per row, y
    against the reference's ``moe_apply``."""
    jcfg, tcfg = _cfgs(**MOE_CASES[name])
    jp, tp = _moe_params(jcfg, seed=2)
    b, s = 3, 37
    x = _rand((b, s, jcfg.d_model), 3)
    _, wtop_w, wtop_e = _ref_route(jp, x, jcfg)
    want, _ = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    y, slot, keep = tmoe.experts(tp, torch.from_numpy(x),
                                 torch.from_numpy(np.asarray(wtop_w)),
                                 torch.from_numpy(np.asarray(wtop_e)).long(),
                                 tcfg)
    np.testing.assert_allclose(_np(y), _np(want), **EXPERT_TOL)
    cap = jmoe.expert_capacity(jcfg, s)
    for r in range(b):
        ws, wk = jmoe._dispatch_indices(wtop_e[r].reshape(-1), cap,
                                        jcfg.moe_num_experts)
        np.testing.assert_array_equal(slot[r].numpy(), np.asarray(ws))
        np.testing.assert_array_equal(keep[r].numpy(), np.asarray(wk))
    if name == "cf05":
        assert not keep.all()


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_apply_matches_reference(name):
    jcfg, tcfg = _cfgs(**MOE_CASES[name])
    jp, tp = _moe_params(jcfg, seed=4)
    x = _rand((2, 41, jcfg.d_model), 5)
    want, waux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg)
    y, aux = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(_np(y), _np(want), **EXPERT_TOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=AUX_RTOL)
    assert y.dtype == torch.float32 and aux.dtype == torch.float32


def test_experts_record_kept_and_dropped_assignments():
    """``experts.kept`` records each call's kept assignments: with
    ``capacity_factor=0.5`` some are dropped, and the counts match the
    keep mask."""
    _, tcfg = _cfgs(capacity_factor=0.5)
    jcfg, _ = _cfgs(capacity_factor=0.5)
    _, tp = _moe_params(jcfg, seed=6)
    x = torch.from_numpy(_rand((2, 64, tcfg.d_model), 7))
    _, top_w, top_e, _ = tmoe.route(tp, x, tcfg)
    calls = tmoe.experts.calls
    tmoe.experts.kept.clear()
    _, _, keep = tmoe.experts(tp, x, top_w, top_e, tcfg)
    assert tmoe.experts.calls == calls + 1
    kept = int(keep.sum())
    assert tmoe.kept_and_dropped() == [(kept, keep.numel() - kept)]
    assert 0 < kept < keep.numel()


def test_moe_in_bfloat16_rounds_as_the_reference():
    """A bf16 model (compute and experts in bf16, the router in f32)
    against the reference's at bf16 ulps."""
    kw = dict(param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    jcfg = jconfigs.get_config("mixtral-8x22b").smoke(
        param_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16)
    tcfg = tconfigs.get_config("mixtral-8x22b").smoke(**kw)
    jp = jinit(jmoe.moe_def(jcfg, tp=1, dp=1), jax.random.PRNGKey(8))
    assert jp["router"].dtype == jnp.float32 and jp["wi"].dtype == jnp.bfloat16
    tp = ParamTree({k: torch.from_numpy(np.asarray(v, np.float32)).to(
        torch.float32 if k == "router" else torch.bfloat16)
        for k, v in jp.items()})
    x = _rand((2, 33, jcfg.d_model), 9)
    want, _ = jmoe.moe_apply(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    y, _ = tmoe.moe_apply(tp, torch.from_numpy(x).bfloat16(), tcfg)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(y), _np(want), rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# the loss, its gradient and the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(capacity_factor=0.5),
                                dict(n_layers=3, moe_first_dense=1,
                                     moe_shared_experts=1)],
                         ids=["mixtral", "cf05", "shared-lead"])
def test_lm_loss_with_aux_and_its_gradient_match_reference(kw):
    """The loss (cross-entropy plus router_aux_weight times the summed aux)
    with per-sample weights, and its gradient leaf by leaf in the
    reference's stacked layout, against ``jax.grad``."""
    jcfg, tcfg = _cfgs(**kw)
    jp = jbuild(jcfg, tp=1, dp=1).init(jax.random.PRNGKey(1))
    tp = lm_params_from_jax(tcfg, jax.tree.map(np.asarray, jp))
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (4, 34))
    w = np.array([0.0, 1.5, 2.0, 0.5], np.float32)
    jloss, jgrad = jax.value_and_grad(jtfm.lm_loss)(
        jp, jnp.asarray(toks), jcfg, sample_weights=jnp.asarray(w))
    _, _, jaux = jtfm.forward(jp, jnp.asarray(toks[:, :-1]), jcfg)
    view, leaves = trainable(tp)
    loss = ttfm.lm_loss(view, torch.from_numpy(toks), tcfg,
                        sample_weights=torch.from_numpy(w))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    _, _, aux = ttfm.forward_aux(tp, torch.from_numpy(toks[:, :-1]), tcfg)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=AUX_RTOL)
    assert float(aux) > 0
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               **STEP1_TOL)
    by_name = dict(zip(leaves, grads))
    got = tckpt._flatten(lm_params_to_stacked(
        tcfg, map_named(tp, lambda name, _: by_name[name])))
    want = jckpt._flatten(jgrad)
    assert sorted(got) == sorted(want)
    assert any("router" in k for k in want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **GRAD_TOL, err_msg=k)


TRAIN_CASE = dict(name="mixtral", arch="mixtral-8x22b",
                  smoke=dict(n_layers=3, moe_first_dense=1,
                             moe_shared_experts=1),
                  scheme="sca", steps=2, clients=2, per_client=2, seq=24,
                  eta=0.05, seed=3)


@pytest.fixture(scope="module")
def ref_train(tmp_path_factory):
    return torch_ref.run_reference_train(
        tmp_path_factory.mktemp("moe_train") / "train.npz",
        cases=(TRAIN_CASE,))


def _nested(blob, prefix):
    return tckpt._nest(torch_ref.prefixed(blob, prefix))


def test_train_step_matches_reference(ref_train):
    """One OTA-FL train step, then a second, from the reference's weights
    on its tokens, fading, coin and per-leaf noise: the loss (with the aux
    term), the metrics and every leaf of the params after each step."""
    c, name, ref = TRAIN_CASE, TRAIN_CASE["name"], ref_train
    tcfg = tconfigs.get_config(c["arch"]).smoke(**c["smoke"])
    params = lm_params_from_jax(tcfg, _nested(ref, f"{name}/params0"))
    scheme = scheme_from_jax(c["scheme"],
                             torch_ref.prefixed(ref, f"{name}/scheme"))
    step = tsteps.make_train_step(tbuild(tcfg, CPU), scheme,
                                  ref[f"{name}/gains"],
                                  tsteps.TrainStepConfig(eta=c["eta"]))
    data = ref[f"{name}/data"]
    for t in range(c["steps"]):
        draws = tsteps.StepDraws(
            h=torch.from_numpy(ref[f"{name}/h/{t}"]).to(torch.complex64),
            coin=torch.tensor(bool(ref[f"{name}/coin/{t}"])),
            z=param_leaves(lm_params_from_jax(
                tcfg, _nested(ref, f"{name}/z/{t}"))))
        tokens = torch.from_numpy(data[t].reshape(-1, c["seq"] + 1)).long()
        params, m = step(params, tokens, draws)
        np.testing.assert_allclose(float(m["loss"]),
                                   ref[f"{name}/loss"][t], **STEP1_TOL)
        assert float(m["active_clients"]) \
            == ref[f"{name}/active_clients"][t]
        got = tckpt._flatten(lm_params_to_stacked(tcfg, params))
        want = torch_ref.prefixed(ref, f"{name}/params/{t}")
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], **STEP1_TOL,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# layout: layer groups, the stacked checkpoint layout, parameter counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(n_layers=3, moe_first_dense=1),
                                dict(n_layers=1, moe_first_dense=1),
                                dict(n_layers=4, moe_first_dense=2,
                                     block_pattern=("swa", "attn"))])
def test_layer_groups_match_the_reference_plan(kw):
    jcfg, tcfg = _cfgs(**kw)
    lead, unit, n_rep, tail = jtfm.layer_plan(jcfg)
    assert layer_groups(tcfg) == (list(lead), list(unit), n_rep, list(tail))
    assert ttfm.layer_sigs(tcfg) == list(lead) + list(unit) * n_rep \
        + list(tail)


def test_stacked_layout_round_trips_a_dense_lead():
    """moe_first_dense=1, a shared expert: lm_params_to_stacked of
    lm_params_from_jax is the reference's tree leaf for leaf, ``lead``
    holding the dense layer; the router stays float32 in a bf16 model."""
    jcfg, tcfg = _cfgs(n_layers=3, moe_first_dense=1, moe_shared_experts=1)
    jp = jax.tree.map(np.asarray, jbuild(jcfg, tp=1, dp=1).init(
        jax.random.PRNGKey(0)))
    assert len(jp["lead"]) == 1 and "router" not in jp["lead"][0]["ffn"]
    back = tckpt._flatten(lm_params_to_stacked(
        tcfg, lm_params_from_jax(tcfg, jp)))
    want = jckpt._flatten(jp)
    assert sorted(back) == sorted(want)
    assert any(k.startswith("lead/0/") for k in want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    bf = lm_params_from_jax(tcfg.replace(param_dtype=torch.bfloat16,
                                         compute_dtype=torch.bfloat16), jp)
    for name, p in bf.state_dict().items():
        want_dt = torch.float32 if name.endswith("router") else torch.bfloat16
        assert p.dtype == want_dt, name


@pytest.mark.parametrize("d", [ParamDef((64, 2, 96), fan_in=64),
                               ParamDef((4, 48, 32), init="scaled"),
                               ParamDef((300, 16), init="embed",
                                        dtype=torch.bfloat16)],
                         ids=["fan_in", "default_fan_in", "embed_bf16"])
def test_init_one_equals_randn_times_scale_bitwise(d):
    """``_init_one`` scales its float32 draw in place before the cast: the
    same numbers as ``randn * scale`` cast, bit for bit."""
    got = _init_one(d, torch.Generator().manual_seed(11))
    draw = torch.randn(d.shape, generator=torch.Generator().manual_seed(11))
    fan = d.fan_in or d.shape[-2]
    scale = 1.0 / math.sqrt(d.shape[-1] if d.init == "embed" else fan)
    want = (draw * scale).to(d.dtype)
    assert got.dtype == d.dtype and torch.equal(got, want)
