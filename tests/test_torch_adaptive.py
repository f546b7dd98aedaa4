"""The port's adaptive integrator (plain PyTorch) against the JAX package.

In float64 on the CPU, with the JAX package's fused kernels switched off, both
sides run the same PI-controlled dopri5 loop with the quartic dense output:
the same attempted and accepted step counts, the same outputs and the same
frozen-mesh gradients of direct backpropagation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchcde_tpu as tc
import torchcde_tpu_torch as tt
from torchcde_tpu.solvers import fused_pallas
from torchcde_tpu.solvers import integrate as jax_integrate
from torchcde_tpu.solvers.terms import MLPVectorField as JaxField
from torchcde_tpu.solvers.terms import make_cde_rhs as jax_rhs
from torchcde_tpu_torch.solvers import integrate
from torchcde_tpu_torch.solvers.terms import MLPVectorField, make_cde_rhs

torch.set_num_threads(1)

B, L, C, H, W = 5, 9, 3, 6, 16
T_OUT = np.array([0.0, 1.3, 4.75, 8.0])


@pytest.fixture(autouse=True)
def jax_general_path():
    fused_pallas.force_fused_pallas(False)
    yield
    fused_pallas.force_fused_pallas(None)


def _problem(seed=1):
    # Paths linear in time: a smooth control keeps the step controller well
    # conditioned.  Where a step straddles a kink of the solution (a knot of
    # a rough spline, a ReLU switching), the error estimate magnifies
    # rounding and two float64 implementations' meshes drift apart.
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 1, C)) + rng.uniform(-1, 1, (B, 1, C)) * np.arange(L)[None, :, None]
    p = dict(w1=rng.standard_normal((H, W)) * 0.5, b1=rng.standard_normal(W) * 0.1,
             w2=rng.standard_normal((W, H * C)) * 0.5, b2=rng.standard_normal(H * C) * 0.1,
             z0=rng.standard_normal((B, H)))
    return x, p


def _torch_field(p):
    field = MLPVectorField(H, C, W, dtype=torch.float64)
    with torch.no_grad():
        field.linear1.weight.copy_(torch.from_numpy(p["w1"].T))
        field.linear1.bias.copy_(torch.from_numpy(p["b1"]))
        field.linear2.weight.copy_(torch.from_numpy(p["w2"].T))
        field.linear2.bias.copy_(torch.from_numpy(p["b2"]))
    return field


def _jax_solve(x, p, t, callable_field, **kwargs):
    def run(x_, z0, w1, b1, w2, b2):
        X = tc.CubicSpline(tc.hermite_cubic_coefficients_with_backward_differences(x_))
        field = JaxField(w1, b1, w2, b2, H, C)
        func = (lambda s, z: field(s, z)) if callable_field else field
        return tc.cdeint(X, func, z0, t, adjoint=False, return_stats=True, **kwargs)

    args = tuple(jnp.asarray(a) for a in (x, p["z0"], p["w1"], p["b1"], p["w2"], p["b2"]))
    out, stats = run(*args)
    proj = np.random.default_rng(7).standard_normal(out.shape)
    grads = jax.grad(lambda *a: jnp.sum(run(*a)[0] * proj), argnums=tuple(range(6)))(*args)
    stats = {k: int(v) for k, v in stats.items()}
    return np.asarray(out), stats, proj, [np.asarray(g) for g in grads]


def _torch_solve(x, p, t, callable_field, proj, backward=True, **kwargs):
    field = _torch_field(p)
    xt = torch.from_numpy(x).requires_grad_()
    z0 = torch.from_numpy(p["z0"]).requires_grad_()
    X = tt.CubicSpline(tt.hermite_cubic_coefficients_with_backward_differences(xt))
    func = (lambda s, z: field(s, z)) if callable_field else field
    out, stats = tt.cdeint(X, func, z0, t, adjoint=False, return_stats=True, **kwargs)
    if not backward:
        return out.detach().numpy(), stats, None
    (out * torch.from_numpy(proj)).sum().backward()
    grads = [xt.grad, z0.grad, field.linear1.weight.grad.T, field.linear1.bias.grad,
             field.linear2.weight.grad.T, field.linear2.bias.grad]
    return out.detach().numpy(), stats, [g.numpy() for g in grads]


def _compare(kwargs, callable_field, seed=1):
    x, p, t = *_problem(seed), T_OUT
    out_j, stats_j, proj, grads_j = _jax_solve(x, p, t, callable_field, **kwargs)
    out_t, stats_t, grads_t = _torch_solve(x, p, t, callable_field, proj, **kwargs)
    assert stats_t == stats_j
    np.testing.assert_allclose(out_t, out_j, rtol=1e-9, atol=1e-12)
    names = ["x", "z0", "w1", "b1", "w2", "b2"]
    for name, got, expected in zip(names, grads_t, grads_j):
        scale = float(np.abs(expected).max())
        np.testing.assert_allclose(got, expected, rtol=1e-8, atol=1e-10 * scale, err_msg=name)
    return stats_t


# An MLP field (return_stats keeps it off the fused route) and a plain
# callable, at the default tolerances.
@pytest.mark.parametrize("callable_field", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_adaptive_cdeint_matches_jax(callable_field, seed):
    stats = _compare(dict(method="dopri5"), callable_field, seed)
    assert stats["steps_rejected"] > 0  # the controller's rejection branch ran


def test_dopri5_at_a_fixed_step_matches_jax():
    stats = _compare(dict(method="dopri5", step_size=0.3), False)
    assert stats["steps_rejected"] == 0


def test_exhausted_budget_poisons_like_jax():
    x, p = _problem()
    out_j, stats_j, proj, _ = _jax_solve(x, p, T_OUT, True, method="dopri5", max_steps=4)
    out_t, stats_t, _ = _torch_solve(x, p, T_OUT, True, proj, backward=False, method="dopri5",
                                     max_steps=4)
    assert stats_t == stats_j and stats_t["steps_attempted"] == 4
    assert np.isnan(out_j).all() and np.isnan(out_t).all()


def test_initial_step_and_dense_output_match_jax():
    x, p = _problem(3)
    Xj = tc.CubicSpline(tc.hermite_cubic_coefficients_with_backward_differences(jnp.asarray(x)))
    rhs_j = jax_rhs(JaxField(*(jnp.asarray(p[k]) for k in ("w1", "b1", "w2", "b2")), H, C), Xj)
    Xt = tt.CubicSpline(tt.hermite_cubic_coefficients_with_backward_differences(torch.from_numpy(x)))
    rhs_t = make_cde_rhs(_torch_field(p), Xt)
    z0j, z0t = jnp.asarray(p["z0"]), torch.from_numpy(p["z0"])
    for t0, rtol, atol in [(0.0, 1e-4, 1e-6), (2.5, 1e-7, 1e-9)]:
        expected = jax_integrate.select_initial_step(rhs_j, jnp.float64(t0), z0j, 5, rtol, atol,
                                                     rhs_j(jnp.float64(t0), z0j))
        got = integrate.select_initial_step(rhs_t, np.float64(t0), z0t, 5, rtol, atol,
                                            rhs_t(np.float64(t0), z0t))
        np.testing.assert_allclose(float(got), float(expected), rtol=1e-12)
    rng = np.random.default_rng(4)
    parts = [rng.standard_normal((B, H)) for _ in range(5)]
    for theta in (0.0, 0.3, 1.0):
        expected = jax_integrate._interp_quartic(*(jnp.asarray(a) for a in parts), jnp.float64(0.7),
                                                 jnp.asarray([theta]))[0]
        got = integrate._interp_quartic(*(torch.from_numpy(a) for a in parts), np.float64(0.7),
                                        np.float64(theta))
        np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-12, atol=1e-14)

