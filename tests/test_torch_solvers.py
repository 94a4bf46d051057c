"""The port's SCA solver (``repro_torch.solvers``) against the reference's
(``repro.solvers``, run in a child process), at the cases of
tests/test_solvers.py, on the CPU in float64.

Tolerances and why:
  * theory (``solvers.theory`` vs ``theory_jax``): rtol 1e-9.  Both sides
    evaluate the same formulas in float64; they differ by the ulps of
    exp/log/lgamma/gammaincc between XLA and PyTorch, ~1e-15 relative.
  * solves: gamma and alpha to 1e-6 relative, the (P1) objective to 1e-9.
    The algorithm and its budgets are the reference's step for step, but
    its stiff penalty stages (mu 1e4, 1e6) are chaotic: a 4e-13 difference
    after the first stage (the ulps above) grows to 6e-2 in the iterate
    after the second, so the outer iterates in the middle of the history
    differ.  The reference does the same to itself: one gain moved by one
    ulp moves its middle history by up to 0.5 and its design by ~6e-9
    (``test_reference_middle_iterates_move_with_an_ulp``).  The polish
    lands both on the same point: measured 5e-9 in gamma and 2e-16 in the
    objective at the Fig.-2 world, 2e-8 at most over these cases.  So the
    start and the end of the history are held, and the port's own history
    is held monotone.
"""
import dataclasses

import numpy as np
import pytest
import torch

import torch_ref
from repro_torch import solvers
from repro_torch.core import theory as ctheory
from repro_torch.core.power_control import make_power_control
from repro_torch.core.channel import FadingSpec
from repro_torch.core.theory import OTAParams
from repro_torch.solvers import sca as tsca
from repro_torch.solvers import theory as tt

THEORY_RTOL = 1e-9
DESIGN_RTOL = 1e-6
OBJECTIVE_RTOL = 1e-9
CPU = "cpu"


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return torch_ref.run_reference_solvers(
        tmp_path_factory.mktemp("solvers") / "solvers.npz")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("tag", list(torch_ref.THEORY_CASES))
def test_theory_matches_reference(ref, tag):
    prm = torch_ref.ota_params(ref, tag)
    pt = tt.from_ota(prm, CPU)
    want = torch_ref.prefixed(ref, tag)
    np.testing.assert_allclose(_np(tt.gamma_max(pt)), want["gamma_max"],
                               rtol=THEORY_RTOL, atol=0)
    np.testing.assert_allclose(_np(tt.alpha_max(pt)), want["alpha_max"],
                               rtol=THEORY_RTOL, atol=0)
    gamma = torch.as_tensor(want["gamma"])
    for name in ("alpha_of_gamma", "log_alpha_of_gamma", "chi_threshold"):
        np.testing.assert_allclose(_np(getattr(tt, name)(gamma, pt)),
                                   want[name], rtol=THEORY_RTOL, atol=0,
                                   err_msg=name)
    z = tt.zeta_terms(gamma, pt)
    for k, v in torch_ref.prefixed(ref, f"{tag}/zeta").items():
        np.testing.assert_allclose(_np(z[k]), v, rtol=THEORY_RTOL,
                                   atol=THEORY_RTOL * float(want["zeta/total"]),
                                   err_msg=k)
    _, _, pm = tt.participation(gamma, pt)
    np.testing.assert_allclose(_np(tt.bias_term(pm, pt)), want["bias_term"],
                               rtol=THEORY_RTOL, atol=1e-300)
    np.testing.assert_allclose(_np(tt.p1_objective(gamma, pt)),
                               want["p1_objective"], rtol=THEORY_RTOL, atol=0)
    # and the port's own numpy theory agrees on the objective
    np.testing.assert_allclose(ctheory.p1_objective(want["gamma"], prm),
                               want["p1_objective"], rtol=1e-6, atol=0)


def test_marcum_q1_matches_reference(ref):
    q = tt.marcum_q1(torch.as_tensor(ref["marcum/a"]),
                     torch.as_tensor(ref["marcum/b"]))
    np.testing.assert_allclose(_np(q), ref["marcum/q"], rtol=THEORY_RTOL,
                               atol=1e-15)


def test_theory_batched_rows_equal_single(ref):
    """A stacked [B] SolverParams gives each row what that row alone
    gives (the solver's batch layout)."""
    tags = [t for t in torch_ref.THEORY_CASES if t.startswith("rician")]
    prms = [torch_ref.ota_params(ref, t) for t in tags[:1]] * 2
    stacked = tt.stack_params(prms, CPU)
    single = tt.from_ota(prms[0], CPU)
    g = tt.gamma_max(stacked)
    assert g.shape == (2, prms[0].num_devices)
    np.testing.assert_array_equal(_np(g[1]), _np(tt.gamma_max(single)))
    obj = tt.p1_objective(0.5 * g, stacked)
    np.testing.assert_allclose(_np(obj[0]),
                               _np(tt.p1_objective(0.5 * g[0], single)),
                               rtol=1e-15, atol=0)


def test_stack_params_rejects_mixed_families():
    gains = np.full(4, 1e-9)
    base = OTAParams(d=100, gmax=10.0, es=1e-3, n0=1e-21, gains=gains,
                     sigma_sq=np.zeros(4))
    rician = base.replace(fading=FadingSpec(family="rician"))
    with pytest.raises(ValueError, match="mixed fading families"):
        tt.stack_params([base, rician], CPU)
    with pytest.raises(ValueError):
        tt.stack_params([], CPU)


def _check_solution(got, want_gamma, want_alpha, want_objective, want_history):
    assert _rel(got["gamma"], want_gamma) <= DESIGN_RTOL
    assert _rel(got["alpha"], want_alpha) <= DESIGN_RTOL
    assert _rel(got["objective"], want_objective) <= OBJECTIVE_RTOL
    hist = np.asarray(got["history"])
    assert hist.shape == np.shape(want_history)
    assert _rel(hist[..., 0], np.asarray(want_history)[..., 0]) \
        <= OBJECTIVE_RTOL
    assert _rel(hist[..., -1], np.asarray(want_history)[..., -1]) \
        <= OBJECTIVE_RTOL


@pytest.fixture(scope="module")
def solved(ref):
    out = {}
    for tag in torch_ref.SOLVE_CASES:
        budget = {"max_iters": 8, "tol": 1e-5} if tag == "legacy_budget" \
            else {}
        cfg = dataclasses.replace(solvers.DEFAULT_CONFIG, **budget)
        out[tag] = solvers.solve(torch_ref.ota_params(ref, tag), cfg=cfg,
                                 device=CPU)
    return out


@pytest.mark.parametrize("tag", torch_ref.SOLVE_CASES)
def test_solve_matches_reference(ref, solved, tag):
    res = solved[tag]
    want = torch_ref.prefixed(ref, tag)
    _check_solution(dict(gamma=res.gamma, alpha=res.alpha,
                         objective=res.objective, history=res.history),
                    want["gamma"], want["alpha"], want["objective"],
                    want["history"])
    np.testing.assert_allclose(res.p, want["p"], rtol=DESIGN_RTOL, atol=0)
    assert res.iterations == (8 if tag == "legacy_budget" else 16)


def test_reference_middle_iterates_move_with_an_ulp(ref):
    """Why the middle of the history is not held: the reference's own
    solve, with one gain moved by one ulp, moves its outer iterates by far
    more than its final design (which stays within DESIGN_RTOL)."""
    base = torch_ref.prefixed(ref, "fig2_world")
    moved = torch_ref.prefixed(ref, "fig2_world_ulp")
    assert np.max(np.abs(moved["history"][1:-1] - base["history"][1:-1])) \
        > 1e-3
    assert _rel(moved["gamma"], base["gamma"]) <= DESIGN_RTOL
    assert _rel(moved["objective"], base["objective"]) <= OBJECTIVE_RTOL


@pytest.mark.parametrize("tag", torch_ref.SOLVE_CASES)
def test_solve_monotone_and_feasible(ref, solved, tag):
    """The port's own history descends, and its point satisfies the
    coupling alpha_m(gamma) = alpha p_m inside the box."""
    res = solved[tag]
    prm = torch_ref.ota_params(ref, tag)
    assert np.all(np.diff(res.history) <= 1e-9), res.history
    gm = ctheory.gamma_max(prm)
    assert np.all(res.gamma > 0)
    assert np.all(res.gamma <= gm * (1 + 1e-9))
    assert abs(res.p.sum() - 1.0) < 1e-9
    am = ctheory.alpha_of_gamma(res.gamma, prm)
    assert np.allclose(am, res.alpha * res.p, rtol=1e-9)


def test_solve_beats_zero_bias(ref, solved):
    prm = torch_ref.ota_params(ref, "prm10")
    zb = ctheory.p1_objective(ctheory.zero_bias_gamma(prm), prm)
    assert solved["prm10"].objective < zb * 0.99
    assert solved["prm10"].converged


def test_solve_batch_matches_reference(ref):
    prms = [torch_ref.ota_params(ref, f"batch{i}")
            for i in range(torch_ref.BATCH_ROWS)]
    br = solvers.solve_batch(prms, device=CPU)
    want = torch_ref.prefixed(ref, "batch")
    assert br.gamma.shape == (torch_ref.BATCH_ROWS, 8)
    assert br.history.shape == want["history"].shape
    _check_solution(dict(gamma=br.gamma, alpha=br.alpha,
                         objective=br.objective, history=br.history),
                    want["gamma"], want["alpha"], want["objective"],
                    want["history"])
    np.testing.assert_array_equal(br.converged, want["converged"])
    # a pre-stacked SolverParams (float32 leaves) gives the same rows
    stacked = tt.stack_params(prms, CPU).to(dtype=torch.float32)
    br32 = solvers.solve_batch(stacked, device=CPU)
    np.testing.assert_allclose(br32.objective, br.objective, rtol=1e-6)


def test_make_sca_default_is_the_torch_solver(ref, solved):
    """``make_sca``'s default (``"torch"``, alias ``"jax"``) is the ported
    solver, ``sca_result`` attached; the legacy budget kwargs map onto
    SolverConfig."""
    from repro_torch.core.channel import deploy, WirelessConfig
    prm = torch_ref.ota_params(ref, "legacy_budget")
    dep = deploy(WirelessConfig(num_devices=8, seed=2))
    pc = make_power_control("sca", dep, prm, method="jax", max_iters=8,
                            tol=1e-5, device=CPU)
    np.testing.assert_array_equal(pc.gamma, solved["legacy_budget"].gamma)
    assert pc.sca_result.iterations == 8
    with pytest.raises(ValueError):
        make_power_control("sca", dep, prm, method="cvx")


def _simplex_oracle(v):
    """Projection onto the simplex by bisection on the threshold (numpy)."""
    lo, hi = v.min() - 1.0, v.max()
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if np.maximum(v - mid, 0.0).sum() > 1.0:
            lo = mid
        else:
            hi = mid
    return np.maximum(v - 0.5 * (lo + hi), 0.0)


@pytest.mark.parametrize("v", [[0.2, 0.2, 0.2, 0.2], [1.0, 1.0, 0.0],
                               [3.0, -1.0, 3.0, 0.5], [0.1], [-5.0, -5.0]])
def test_project_simplex_ties_and_edges(v):
    v = np.asarray(v, np.float64)
    got = _np(tsca.project_simplex(torch.as_tensor(v)))
    np.testing.assert_allclose(got, _simplex_oracle(v), atol=1e-12)
    assert abs(got.sum() - 1.0) < 1e-12 and np.all(got >= 0)


def test_project_simplex_matches_oracle_property():
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    @hyp.settings(max_examples=60, deadline=None)
    @hyp.given(st.lists(st.floats(-10, 10, allow_nan=False), min_size=1,
                        max_size=21))
    def check(vals):
        v = np.asarray(vals, np.float64)
        got = _np(tsca.project_simplex(torch.as_tensor(v)[None]))[0]
        np.testing.assert_allclose(got, _simplex_oracle(v), atol=1e-9)

    check()


def test_solver_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    prm = OTAParams(d=100, gmax=10.0, es=1e-3, n0=1e-21,
                    gains=np.full(3, 1e-9), sigma_sq=np.zeros(3))
    with pytest.raises(RuntimeError, match="CUDA"):
        solvers.solve(prm)
