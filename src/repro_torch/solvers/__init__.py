"""The batched SCA solver in torch float64 (ported from ``repro.solvers``).

``theory``  the Theorem-1 statistical-CSI quantities on tensors (all
            fading families), batched, differentiable by autograd.
``sca``     the SCA solver: ``solve`` (one scenario, a drop-in for
            ``core.sca.solve_sca``), ``solve_batch`` (a stacked batch) and
            ``solve_batch_traced`` (the redesign paths' solve, which fires
            the hook of ``set_trace_hook``).

``core/sca.py`` (scipy SLSQP) remains the reference oracle.
"""
from repro_torch.solvers.sca import (BatchResult, DEFAULT_CONFIG,
                                     SolverConfig, set_trace_hook, solve,
                                     solve_batch, solve_batch_traced)
from repro_torch.solvers.theory import SolverParams, from_ota, stack_params

__all__ = [
    "BatchResult", "DEFAULT_CONFIG", "SolverConfig", "SolverParams",
    "from_ota", "set_trace_hook", "solve", "solve_batch",
    "solve_batch_traced", "stack_params",
]
