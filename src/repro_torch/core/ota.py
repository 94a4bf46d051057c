"""OTA aggregation operators (paper eqs. (3)-(6)), ported from
``repro.core.ota``.

Every tensor carries a leading cell axis C (one cell per (scheme, seed) of
the fleet); gradients add a device axis: [C, N, ...].  Random draws are
inputs, never made here: the fleet's draws provider hands each round its
fading ``h`` (or the innovations a fading process turns into h) and its
receiver noise ``z`` (raveled in leaf order).  Every scheme reduces, per
round, to ``(s [C, N], noise_scale [C])``:

    g_hat = sum_m s_m * g_m  +  noise_scale * z,     z ~ N(0, I_d)

The fading families (``repro.core.ota``'s draws) are written as pure
transforms of their random inputs -- standard normals for the Gaussian
(Rayleigh / Rician) families, Gamma(m) variates and phase uniforms for
Nakagami-m -- with thin ``draw_*`` wrappers that draw those inputs from an
explicit ``torch.Generator``.  The transforms are float32, as the
reference's are.  Two kinds of value must not depend on where an element
sits in a vectorized CPU loop (the scenario stack computes its rows at
another shape than a standalone process), and must round as the
reference's correctly rounded float32 sqrt: the per-device constants
(``fading_scales``: numpy float32 on the host, once) and Nakagami's
magnitude, cos and sin (float64, rounded to float32).  PyTorch's CPU sqrt
of a float32 tensor may land an ulp off.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.kernels import ops as kops

UPLINK_DTYPES = kops.UPLINK_DTYPES

# Marsaglia-Tsang rejection rounds per Gamma variate.  Each round accepts
# with probability > 0.95 for shape >= 1 (the sampler always runs at shape
# >= 1: m < 1 is boosted), so 12 masked rounds leave a variate unaccepted
# with probability < 1e-15; such a variate takes d = shape - 1/3 (close to
# the mode) instead of stalling the stream on a host sync.
GAMMA_ROUNDS = 12
TWO_PI = 2.0 * math.pi


class Innovations(NamedTuple):
    """One round's fading innovations for S seed rows of N devices; the
    fading processes (``core.scenarios``) turn them into h.

    n_re, n_im   [S, N] f32 standard normals: the scattered component
    drop_u       [S, N] f32 uniforms in [0, 1): device dropout (or None)
    gamma_n      [GAMMA_ROUNDS, S, N] f64 normals  } Marsaglia-Tsang
    gamma_u      [GAMMA_ROUNDS, S, N] f64 uniforms } inputs (Nakagami;
    boost_u      [S, N] f64 uniforms: the m < 1 boost } None without)
    phase_u      [S, N] f32 uniforms in [0, 1): Nakagami's phase
    """
    n_re: torch.Tensor
    n_im: torch.Tensor
    drop_u: Optional[torch.Tensor] = None
    gamma_n: Optional[torch.Tensor] = None
    gamma_u: Optional[torch.Tensor] = None
    boost_u: Optional[torch.Tensor] = None
    phase_u: Optional[torch.Tensor] = None


def draw_normals(shape, generator: torch.Generator, device):
    """The scattered component's (n_re, n_im), f32, in ``draw_fading``'s
    order: real parts, then imaginary parts."""
    return (torch.randn(tuple(shape), generator=generator, device=device),
            torch.randn(tuple(shape), generator=generator, device=device))


def draw_gamma_inputs(shape, generator: torch.Generator, device):
    """Nakagami's random inputs of ``shape``: (gamma_n, gamma_u, boost_u,
    phase_u) as ``Innovations`` lays them out."""
    shape = tuple(shape)
    lead = (GAMMA_ROUNDS,) + shape
    f64 = dict(generator=generator, device=device, dtype=torch.float64)
    return (torch.randn(lead, **f64), torch.rand(lead, **f64),
            torch.rand(shape, **f64),
            torch.rand(shape, generator=generator, device=device))


def gaussian_fading(n_re: torch.Tensor, n_im: torch.Tensor,
                    scale: torch.Tensor,
                    los: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h = (los + n_re * scale) + i (n_im * scale), f32: Rayleigh with
    ``scale = sqrt(Lambda / 2)`` and no LOS; Rician with ``scale =
    sqrt(Lambda / (K + 1) / 2)`` and ``los = sqrt(Lambda K / (K + 1))``
    (``fading_scales``).  A Rayleigh row through the Rician form (K = 0:
    Lambda / 1 and sqrt(Lambda 0 / 1) = 0 are exact) is bitwise the
    Rayleigh form."""
    re = n_re * scale
    if los is not None:
        re = los + re
    return torch.complex(re, n_im * scale)


def fading_scales(gains, k_factor=None):
    """(scale, los) of the Gaussian draw, numpy float32, in the
    reference's order of float32 operations: diffuse = Lambda / (K + 1),
    scale = sqrt(diffuse / 2), los = sqrt(Lambda K / (K + 1)); K = 0
    (Rayleigh) gives Lambda / 1 and los 0 exactly."""
    g = np.asarray(gains, np.float32)
    k = np.zeros_like(g) if k_factor is None \
        else np.broadcast_to(np.asarray(k_factor, np.float32), g.shape)
    one, two = np.float32(1.0), np.float32(2.0)
    return np.sqrt(g / (k + one) / two), np.sqrt(g * k / (k + one))


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def draw_fading(gains: torch.Tensor, rows: int,
                generator: torch.Generator) -> torch.Tensor:
    """h_m ~ CN(0, Lambda_m): complex64 [rows, N] (real, then imaginary
    parts drawn from ``generator``)."""
    scale = torch.as_tensor(fading_scales(_host(gains))[0],
                            device=gains.device)
    n_re, n_im = draw_normals((rows,) + tuple(gains.shape), generator,
                              gains.device)
    return gaussian_fading(n_re, n_im, scale)


def draw_fading_rician(gains: torch.Tensor, k_factor: torch.Tensor,
                       rows: int, generator: torch.Generator) -> torch.Tensor:
    """Rician: LOS sqrt(K Lambda/(K+1)) + diffuse CN(0, Lambda/(K+1)),
    complex64 [rows, N]; E|h|^2 = Lambda."""
    scale, los = (torch.as_tensor(a, device=gains.device)
                  for a in fading_scales(_host(gains), _host(k_factor)))
    n_re, n_im = draw_normals((rows,) + tuple(gains.shape), generator,
                              gains.device)
    return gaussian_fading(n_re, n_im, scale, los)


def gamma_variates(m: torch.Tensor, normals: torch.Tensor,
                   uniforms: torch.Tensor,
                   boost_u: torch.Tensor) -> torch.Tensor:
    """Gamma(m, 1) variates, float64, from Marsaglia-Tsang's rejection
    sampler run for a fixed number of masked rounds (``normals`` and
    ``uniforms`` carry the rounds on their leading axis; no host sync).

    Shape a = m (m >= 1) or m + 1 (m < 1): d = a - 1/3, c = 1/sqrt(9 d);
    a round proposes v = (1 + c x)^3 from its normal x and accepts with its
    uniform u when v > 0 and (u < 1 - 0.0331 x^4 or log u < x^2/2 +
    d (1 - v + log v)); the variate is d v of the first accepting round.
    For m < 1 the Gamma(m + 1) variate is boosted by U^(1/m).  The
    algorithm is the reference's (``jax.random.gamma``), its inputs are not
    (threefry), so the port's variates match it in distribution only; the
    tests hold the moments, and the Nakagami transform bitwise on the
    reference's own variates."""
    m = m.double()
    small = m < 1.0
    a = torch.where(small, m + 1.0, m)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.zeros(torch.broadcast_shapes(d.shape, normals.shape[1:]),
                      dtype=torch.float64, device=normals.device)
    done = torch.zeros(out.shape, dtype=torch.bool, device=out.device)
    for x, u in zip(normals, uniforms):
        v = 1.0 + c * x
        v = v * v * v
        pos = v > 0.0
        vs = torch.where(pos, v, torch.ones_like(v))
        accept = pos & ((u < 1.0 - 0.0331 * (x * x) * (x * x))
                        | (torch.log(u) < 0.5 * x * x
                           + d * (1.0 - vs + torch.log(vs))))
        out = torch.where(accept & ~done, d * vs, out)
        done = done | accept
    out = torch.where(done, out, d.expand(out.shape))
    boost = torch.where(small, torch.pow(boost_u, 1.0 / m),
                        torch.ones_like(boost_u))
    return out * boost


def nakagami_fading(gains: torch.Tensor, m: torch.Tensor,
                    gamma: torch.Tensor,
                    phase_u: torch.Tensor) -> torch.Tensor:
    """Nakagami-m from its Gamma(m) variates and phase uniforms, as the
    reference: |h|^2 = Gamma(m) Lambda / m, phase = 2 pi u; E|h|^2 =
    Lambda.  The power is f32; the magnitude, cos and sin run in f64 and
    round to f32 (see the module docstring)."""
    power = gamma.float() * gains.float() / m.float()
    mag = torch.sqrt(power.double()).float()
    phase = (phase_u * TWO_PI).double()
    return torch.complex(mag * torch.cos(phase).float(),
                         mag * torch.sin(phase).float())


def draw_fading_nakagami(gains: torch.Tensor, m: torch.Tensor, rows: int,
                         generator: torch.Generator) -> torch.Tensor:
    """Nakagami-m: |h|^2 ~ Gamma(m, Lambda/m), uniform phase, complex64
    [rows, N]; E|h|^2 = Lambda.  Gamma(m) by ``gamma_variates`` from the
    generator's normals and uniforms (torch's own Gamma sampler takes no
    generator)."""
    gn, gu, bu, pu = draw_gamma_inputs((rows,) + tuple(gains.shape),
                                       generator, gains.device)
    return nakagami_fading(gains, m, gamma_variates(m, gn, gu, bu), pu)


def add_receiver_noise(tree: dict, noise_scale: torch.Tensor,
                       z: torch.Tensor) -> dict:
    """g + noise_scale * z per leaf; z is the raveled noise [C, D]."""
    zt = kops.unravel(z, tree, 1)
    out = {}
    for k, leaf in tree.items():
        ns = noise_scale.reshape((-1,) + (1,) * (leaf.dim() - 1))
        out[k] = leaf + (ns * zt[k]).to(leaf.dtype)
    return out


def add_receiver_noise_leaves(grads: dict, noise_scale: torch.Tensor,
                              z: dict) -> dict:
    """The reference's per-leaf form, ``g + (noise_scale * z_leaf)`` cast
    to the leaf's dtype, one z per leaf: ``grads`` and ``z`` are dicts by
    leaf name (the LM train step's leaves, any nesting flattened into
    names; z float32), ``noise_scale`` a scalar tensor."""
    return {k: g + (noise_scale * z[k]).to(g.dtype) for k, g in grads.items()}


def per_client_loss_weights(s: torch.Tensor) -> torch.Tensor:
    """Weights w_m = N s_m, so that mean_m(w_m f_m) = sum_m s_m f_m.

    The gradient of the mean per-client loss is (1/N) sum_m grad f_m;
    scaling client m's loss by N s_m makes that one gradient the OTA
    superposition sum_m s_m grad f_m (the weighted-loss form of the
    reference's train step)."""
    return s.shape[0] * s


def weighted_sum(stacked: dict, s: torch.Tensor) -> dict:
    """sum_m s_m * g_m over the device axis of every [C, N, ...] leaf.

    Accumulates in float32 and casts on write: casting ``s`` to a
    low-precision leaf dtype first would lose coefficient precision.
    """
    out = {}
    for k, leaf in stacked.items():
        w = s.float().reshape(s.shape + (1,) * (leaf.dim() - 2))
        out[k] = torch.sum(w * leaf.float(), dim=1).to(leaf.dtype)
    return out


def apply_round_coeffs(stacked_grads: dict, s: torch.Tensor,
                       noise_scale: torch.Tensor, z: torch.Tensor,
                       flat: bool = False, uplink_dtype: str = "f32",
                       use_kernel: Optional[bool] = None) -> dict:
    """Aggregate with precomputed per-round coefficients.

    flat=False: the per-leaf path (the reference's oracle).
    flat=True:  ravel once and run one flat aggregation for the fleet
                (kernel K2 on CUDA, its plain version on the CPU).
    ``uplink_dtype`` (flat only) quantizes the wire before aggregation.
    """
    if flat:
        return kops.ota_aggregate_pytree(stacked_grads, s, noise_scale, z,
                                         uplink_dtype=uplink_dtype,
                                         use_kernel=use_kernel)
    if uplink_dtype != "f32":
        raise ValueError("quantized uplink requires the flat aggregation "
                         f"path (flat=True), got uplink_dtype={uplink_dtype!r}")
    return add_receiver_noise(weighted_sum(stacked_grads, s), noise_scale, z)


def fused_round_step(stacked_grads: dict, s: torch.Tensor,
                     noise_scale: torch.Tensor, z: torch.Tensor,
                     params: dict, eta: torch.Tensor,
                     uplink_dtype: str = "f32",
                     use_kernel: Optional[bool] = None) -> dict:
    """The whole flat-path round tail -- quantized uplink, superposition,
    receiver noise, SGD step -- as one launch (kernel K1 on CUDA, its plain
    version on the CPU); returns the updated params."""
    return kops.ota_round_step_pytree(stacked_grads, s, noise_scale, z,
                                      params, eta, uplink_dtype=uplink_dtype,
                                      use_kernel=use_kernel)
