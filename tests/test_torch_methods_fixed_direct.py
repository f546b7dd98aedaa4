"""Every fixed-step method of the JAX package through the port's ``cdeint`` with
direct backpropagation, against the JAX package in float64 on the CPU: values, solver
statistics and the gradients with respect to the path, z0 and the field's
weights within 1e-8 of their largest magnitudes (``parity_case`` in
``tests/test_torch_solver_surface.py``, which says why its path is linear
in time).  The cases are split over four files to keep each file short.
"""

import pytest

from test_torch_solver_surface import FIXED, jax_general_path, parity_case  # noqa: F401


@pytest.mark.parametrize("method", FIXED)
def test_fixed_method_matches_jax_direct(method):
    parity_case(method, adjoint=False)
