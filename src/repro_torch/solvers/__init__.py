"""The batched SCA solver in torch float64 (ported from ``repro.solvers``).

``theory``  the Theorem-1 statistical-CSI quantities on tensors (all
            fading families), batched, differentiable by autograd.
``sca``     the SCA solver: ``solve`` (one scenario, a drop-in for
            ``core.sca.solve_sca``) and ``solve_batch`` (a stacked batch).

``core/sca.py`` (scipy SLSQP) remains the reference oracle.
"""
from repro_torch.solvers.sca import (BatchResult, DEFAULT_CONFIG,
                                     SolverConfig, solve, solve_batch)
from repro_torch.solvers.theory import SolverParams, from_ota, stack_params

__all__ = [
    "BatchResult", "DEFAULT_CONFIG", "SolverConfig", "SolverParams",
    "from_ota", "solve", "solve_batch", "stack_params",
]
