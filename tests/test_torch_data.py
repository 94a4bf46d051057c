"""The port's numpy copies (data, partition, channel, theory, config) are
bit for bit the reference's."""
import numpy as np
import pytest

from repro.configs import paper_mlp as jcfg
from repro.core import channel as jch
from repro.core import theory as jth
from repro.data import partition as jpart
from repro.data import synthetic as jsyn
from repro_torch.configs import paper_mlp as tcfg
from repro_torch.core import channel as tch
from repro_torch.core import theory as tth
from repro_torch.data import partition as tpart
from repro_torch.data import synthetic as tsyn


def _eq(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


@pytest.mark.parametrize("spc,noise,seed", [(40, 0.75, 0), (25, 0.35, 3)])
def test_mnist_like_bitwise(spc, noise, seed):
    _eq(tsyn.mnist_like(spc, noise=noise, seed=seed, test_per_class=7),
        jsyn.mnist_like(spc, noise=noise, seed=seed, test_per_class=7))


@pytest.mark.parametrize("seed", [0, 1])
def test_partition_and_stack_bitwise(seed):
    x, y, _, _ = jsyn.mnist_like(30, seed=seed)
    t = tpart.partition_by_label(x, y, 10, 2, 2, seed=seed)
    j = jpart.partition_by_label(x, y, 10, 2, 2, seed=seed)
    _eq(t, j)
    _eq(tpart.stack_shards(t), jpart.stack_shards(j))
    assert tpart.label_assignment(10, 10) == jpart.label_assignment(10, 10)


@pytest.mark.parametrize("n,seed", [(10, 0), (7, 5)])
def test_deploy_bitwise(n, seed):
    t = tch.deploy(tch.WirelessConfig(num_devices=n, seed=seed))
    j = jch.deploy(jch.WirelessConfig(num_devices=n, seed=seed))
    _eq((t.distances, t.gains), (j.distances, j.gains))
    tc = tch.WirelessConfig()
    jc = jch.WirelessConfig()
    assert (tc.energy_per_sample, tc.noise_psd) == \
        (jc.energy_per_sample, jc.noise_psd)


@pytest.mark.parametrize("family", ["rayleigh", "rician", "nakagami"])
def test_magnitude_sf_bitwise(family):
    gains = np.geomspace(1e-13, 1e-10, 6)
    x = np.sqrt(gains) * 0.7
    _eq(tch.fading_magnitude_sf(gains, x, tch.FadingSpec(family)),
        jch.fading_magnitude_sf(gains, x, jch.FadingSpec(family)))


def _prm(mod, chmod, d=814_090):
    cfg = chmod.WirelessConfig(num_devices=10, seed=0)
    dep = chmod.deploy(cfg)
    return mod.OTAParams(d=d, gmax=10.0, es=cfg.energy_per_sample,
                         n0=cfg.noise_psd, gains=dep.gains,
                         sigma_sq=np.zeros(10), eta=0.06, kappa_sq=4.0)


@pytest.mark.parametrize("d", [12_730, 814_090])
def test_theory_bitwise(d):
    tp, jp = _prm(tth, tch, d), _prm(jth, jch, d)
    gam = 0.6 * jth.gamma_max(jp)
    _eq(tth.gamma_max(tp), jth.gamma_max(jp))
    _eq(tth.alpha_max(tp), jth.alpha_max(jp))
    _eq(tth.chi_threshold(gam, tp), jth.chi_threshold(gam, jp))
    _eq(tth.alpha_of_gamma(gam, tp), jth.alpha_of_gamma(gam, jp))
    _eq(tth.participation(gam, tp), jth.participation(gam, jp))
    tz, jz = tth.zeta_terms(gam, tp), jth.zeta_terms(gam, jp)
    assert tz == jz
    assert tth.p1_objective(gam, tp) == jth.p1_objective(gam, jp)
    _eq(tth.zero_bias_gamma(tp), jth.zero_bias_gamma(jp))


def test_paper_config_copy():
    assert tcfg.CONFIG.__dict__ == jcfg.CONFIG.__dict__
    assert tcfg.CONFIG.wireless().__dict__ == jcfg.CONFIG.wireless().__dict__
