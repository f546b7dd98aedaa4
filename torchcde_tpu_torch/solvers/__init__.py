from .adjoint import odeint_adjoint
from .cdeint import cdeint
from .fused_fixed import disable_fused_dispatch, force_fused_kernels
from .integrate import SolverConfig, odeint
from .terms import make_cde_rhs

__all__ = ["SolverConfig", "cdeint", "disable_fused_dispatch", "force_fused_kernels",
           "make_cde_rhs", "odeint", "odeint_adjoint"]
