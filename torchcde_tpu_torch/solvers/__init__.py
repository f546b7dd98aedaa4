from .cdeint import cdeint
from .integrate import SolverConfig

__all__ = ["SolverConfig", "cdeint"]
