"""The port's power control against the reference: designs bit for bit
(the numpy/scipy copies), and the per-round coefficients (s, noise_scale)
of all 8 schemes on the reference's own fading draws and coins.

Coefficient tolerance rtol 1e-5: both sides compute in f32 from f32 design
leaves, but |h| of a complex64 and exp/log differ by an ulp between XLA and
PyTorch (about a third of |h| values).  For the truncated schemes that can
only flip chi when |h| sits within an ulp of a threshold; for OPC it moves
the grid points and the chosen c* by ulps (its argmin over a 128-point grid
and two 33-point zooms would flip only if two candidates tied to an ulp).
The draws are replayed exactly, so no difference comes from the channel.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ref
from repro.core import channel as jch
from repro.core import ota as jota
from repro.core import power_control as jpc
from repro.core import sca as jsca
from repro.core.theory import OTAParams as JPrm
from repro_torch.core import channel as tch
from repro_torch.core import power_control as tpc
from repro_torch.core import sca as tsca
from repro_torch.core.theory import OTAParams as TPrm

TOL = dict(rtol=1e-5, atol=0)
ROUNDS = 12


def _world(chmod, prm_cls, d):
    cfg = chmod.WirelessConfig(num_devices=10, seed=0)
    dep = chmod.deploy(cfg)
    prm = prm_cls(d=d, gmax=10.0, es=cfg.energy_per_sample, n0=cfg.noise_psd,
                  gains=dep.gains, sigma_sq=np.zeros(10), eta=0.06,
                  lsmooth=1.0, kappa_sq=4.0)
    return dep, prm


@pytest.fixture(scope="module", params=[12_730, 814_090])
def worlds(request):
    d = request.param
    jdep, jprm = _world(jch, JPrm, d)
    tdep, tprm = _world(tch, TPrm, d)
    jschemes = {n: jpc.make_power_control(n, jdep, jprm, method="scipy")
                if n == "sca" else jpc.make_power_control(n, jdep, jprm)
                for n in tpc.SCHEMES}
    tschemes = {n: tpc.make_power_control(n, tdep, tprm) for n in tpc.SCHEMES}
    keys = jax.random.split(jax.random.PRNGKey(d), ROUNDS)
    gains = jnp.asarray(jdep.gains)
    h, coin = [], []
    for k in keys:
        k_fade, k_coeff = jax.random.split(k)
        h.append(np.asarray(jota.draw_fading(k_fade, gains)))
        coin.append(bool(jax.random.bernoulli(k_coeff, 0.5)))
    return dict(jprm=jprm, tprm=tprm, j=jschemes, t=tschemes, keys=keys,
                h=np.stack(h), coin=np.asarray(coin))


def test_sca_gamma_equals_reference_slsqp(worlds):
    t = tsca.solve_sca(worlds["tprm"])
    j = jsca.solve_sca(worlds["jprm"])
    np.testing.assert_array_equal(t.gamma, j.gamma)
    assert t.iterations == j.iterations and t.history == j.history


@pytest.mark.parametrize("name", tpc.SCHEMES)
def test_designs_equal_reference(worlds, name):
    want = torch_ref.scheme_fields(worlds["j"][name])
    got = torch_ref.scheme_fields(worlds["t"][name])
    assert set(got) == set(want)
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def _reference_coeffs(pc, h, keys):
    """The reference's class path, per round, and the fleet's union path
    (stack_schemes + vmapped round_coeffs), which is what run_fleet uses."""
    out = []
    for hh, k in zip(h, keys):
        k_coeff = jax.random.split(k)[1]
        out.append(pc.round_coeffs(jnp.asarray(hh), k_coeff))
    return (np.stack([np.asarray(s) for s, _ in out]),
            np.asarray([float(n) for _, n in out]))


@pytest.mark.parametrize("build", ["scheme_from_jax", "port_design"])
@pytest.mark.parametrize("name", tpc.SCHEMES)
def test_round_coeffs_match_reference(worlds, name, build):
    jp = worlds["j"][name]
    tp = tpc.scheme_from_jax(name, torch_ref.scheme_fields(jp)) \
        if build == "scheme_from_jax" else worlds["t"][name]
    want_s, want_ns = _reference_coeffs(jp, worlds["h"], worlds["keys"])
    s, ns = tp.round_coeffs(torch.from_numpy(worlds["h"]),
                            torch.from_numpy(worlds["coin"]))
    assert s.shape == (ROUNDS, 10) and ns.shape == (ROUNDS,)
    assert s.dtype == ns.dtype == torch.float32
    np.testing.assert_allclose(s.numpy(), want_s, **TOL)
    np.testing.assert_allclose(ns.numpy(), want_ns, **TOL)


def test_union_fleet_coeffs_match(worlds):
    """The reference fleet stacks the 8 schemes into its SchemeBatch union
    (f32 design leaves under vmap); the port's per-scheme objects agree."""
    names = tpc.SCHEMES
    stacked = jpc.stack_schemes([worlds["j"][n] for n in names])
    for r in range(ROUNDS):
        kc = jax.random.split(worlds["keys"][r])[1]
        s_u, ns_u = jpc.round_coeffs_fleet(
            stacked, jnp.asarray(worlds["h"][r]),
            jnp.stack([kc] * len(names)))
        h = torch.from_numpy(worlds["h"][r:r + 1])
        coin = torch.from_numpy(worlds["coin"][r:r + 1])
        for i, n in enumerate(names):
            s, ns = worlds["t"][n].round_coeffs(h, coin)
            np.testing.assert_allclose(s[0].numpy(), np.asarray(s_u[i]),
                                       **TOL, err_msg=n)
            np.testing.assert_allclose(float(ns[0]), float(ns_u[i]),
                                       **TOL, err_msg=n)


def test_unknown_scheme_raises():
    dep, prm = _world(tch, TPrm, 100)
    with pytest.raises(ValueError):
        tpc.make_power_control("adaptive_sca", dep, prm)
    with pytest.raises(ValueError):
        tpc.scheme_from_jax("nope", {})
