"""Per-round Theorem-1 diagnostics, ported from
``repro.telemetry.diagnostics``.

The paper's convergence bound trades a *bias* term -- the realized
aggregation weights deviating from uniform 1/N -- against a *variance*
term: effective receiver noise plus participation randomness.
``make_metrics_hook`` returns a collector the round body
(``fl.engine.make_round_body(metrics_hook=)``) calls right after the OTA
coefficients are fixed, on the realized per-device weights ``s`` and
``noise_scale`` the aggregation consumed, so the diagnostics can never
disagree with the update they describe.

The port's round works on a leading cell axis: the hook takes ``s`` [C, N],
``noise_scale`` [C], each cell's drawn channel ``h`` [C, N] and the
parameters (leaves [C, ...], read for their sizes only) and returns one
[C] float32 trace per metric, in the reference's float32 arithmetic (the
bias power is ``solvers.theory.bias_term``'s map, computed here in f32 as
the reference traces it, not in the solver's f64).  Left at None, the
round body issues exactly the launches it issues without telemetry.
"""
from __future__ import annotations

from typing import Callable

import torch

# every diagnostic trace is namespaced so tools (and the report renderer)
# can select them without a registry
DIAG_PREFIX = "bv_"


def make_metrics_hook(kappa_sq: float = 1.0) -> Callable:
    """Build the per-round collector:

        hook(s=..., noise_scale=..., h=..., params=...) -> {name: [C] f32}

    ``kappa_sq`` is the paper's gradient-dissimilarity bound (kappa^2 in
    Theorem 1), so the traced bias power is in the SCA objective's units.
    """
    kappa = torch.tensor(float(kappa_sq), dtype=torch.float32)

    def hook(s, noise_scale, h, params):
        n = s.shape[-1]
        d = sum(int(v[0].numel()) for v in params.values())
        tot = torch.sum(s, dim=-1, keepdim=True)
        # realized participation weights; an all-truncated round (s == 0)
        # realizes the uniform point, i.e. zero bias by convention
        pm = torch.where(tot > 0, s / torch.where(tot == 0, 1.0, tot),
                         1.0 / n)
        k = kappa.to(s.device)
        return {
            # Theorem-1 bias power at the REALIZED participation pattern
            DIAG_PREFIX + "bias_power":
                2.0 * n * k * torch.sum(torch.square(pm - 1.0 / n), dim=-1),
            # raw deviation of the realized weights from uniform
            DIAG_PREFIX + "weight_dev":
                torch.sum(torch.square(s - 1.0 / n), dim=-1),
            # effective noise variance of the update over the d coordinates
            DIAG_PREFIX + "noise_var":
                d * torch.square(noise_scale.float()),
            # realized channel power entering the round (mean over devices)
            DIAG_PREFIX + "chan_power":
                torch.mean(torch.square(torch.abs(h)), dim=-1),
        }

    return hook


def is_diagnostic(trace_name: str) -> bool:
    return trace_name.startswith(DIAG_PREFIX)
