"""``method="scipy_solver"`` in the port against the JAX package.

Host stepping by ``scipy.integrate.solve_ivp`` in float64 on the CPU: on a
path linear in time the port's values are the JAX package's within 1e-8 of
their largest magnitude; on the rough spline of the JAX package's test the
two right-hand sides' rounding parts solve_ivp's meshes, and both are held to
that test's tight-solve check.  Also the ``adjoint=True`` warning and the
refusals (per-sample, batched t, statistics).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchcde_tpu as tc
import torchcde_tpu_torch as tt
from test_torch_solver_surface import (  # noqa: F401
    _both, _close, _rough, _rough_solve, _run, _smooth, jax_general_path)

torch.set_num_threads(1)


def test_scipy_solver_matches_jax():
    # On a path linear in time, solve_ivp takes the same steps on both
    # packages' right-hand sides.
    x, z0, w = _smooth(5)
    for solver in ("RK45", "LSODA"):
        kwargs = dict(adjoint=False, method="scipy_solver", rtol=1e-8, atol=1e-10,
                      options=dict(solver=solver))
        out_j = _run(tc, jnp.asarray(x), jnp.asarray(z0), jnp.asarray(w), np.arange(5.0), **kwargs)
        out = _run(tt, torch.from_numpy(x), torch.from_numpy(z0), torch.from_numpy(w),
                   np.arange(5.0), **kwargs)
        assert out.dtype == torch.float64
        _close(out, out_j, solver)


def test_scipy_solver_backend():
    # On the rough spline solve_ivp's meshes part between the two packages'
    # right-hand sides (rounding): both are held to the JAX test's check.
    x, v, z0 = _rough(seed=47)
    ref = _rough_solve(tt, x, v, z0, adjoint=False, method="dopri5", rtol=1e-8, atol=1e-10)
    for solver in ("RK45", "LSODA"):
        out_j, out = _both(x, v, z0, adjoint=False, method="scipy_solver", rtol=1e-8,
                           atol=1e-10, options=dict(solver=solver))
        assert out.shape == ref.shape and out.dtype == torch.float64
        assert np.allclose(out.numpy(), ref.numpy(), atol=1e-5), solver
        assert np.allclose(out_j, ref.numpy(), atol=1e-5), solver


def test_scipy_solver_refusals_and_adjoint():
    x, v, z0 = _rough(seed=48)
    with pytest.warns(UserWarning, match="adjoint=True is ignored"):
        out = _rough_solve(tt, x, v, z0, adjoint=True, method="scipy_solver")
    ref = _rough_solve(tt, x, v, z0, adjoint=False, method="scipy_solver")
    assert torch.equal(out, ref)
    X = tt.CubicSpline(tt.hermite_cubic_coefficients_with_backward_differences(torch.from_numpy(x)))
    f = lambda t, z: torch.sigmoid(z)[..., None] + torch.from_numpy(v)  # noqa: E731
    z0t = torch.from_numpy(z0)
    with pytest.raises(ValueError, match="per_sample"):
        tt.cdeint(X, f, z0t, X.interval, adjoint=False, method="scipy_solver",
                  options=dict(per_sample=True))
    t2 = np.stack([X.interval, X.interval])
    with pytest.raises(ValueError, match="per_sample"):
        tt.cdeint(X, f, z0t, t2, adjoint=False, method="scipy_solver",
                  options=dict(per_sample=True))
    with pytest.raises(ValueError, match="does not collect solver statistics"):
        tt.cdeint(X, f, z0t, X.interval, adjoint=False, method="scipy_solver", return_stats=True)
