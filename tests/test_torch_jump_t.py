"""``options={'jump_t': ...}`` in the port against the JAX package.

In float64 on the CPU: adaptive steps land on the declared jumps (dopri5
swaps to its stateless stepper, the backsolve adjoint lands on the negated
jumps), fixed steps ignore them with the JAX package's warning, unsorted jumps
give the sorted ones' mesh, and no fused route takes a solve with jumps except
the reversible adjoint's K8, after its warning, as in the JAX package.
Values, gradients (within 1e-8 of their largest magnitudes) and solver
statistics are the JAX package's, on paths linear in time
(``tests/test_torch_solver_surface.py`` says why).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchcde_tpu as tc
import torchcde_tpu_torch as tt
from test_torch_solver_surface import (  # noqa: F401
    FIXED, H, C, _close, _kwargs, _parity, _rough, _rough_solve, _run, _smooth, count_routes,
    jax_general_path)
from torchcde_tpu.solvers import integrate as jax_integrate
from torchcde_tpu_torch.solvers import integrate
from torchcde_tpu_torch.solvers.terms import MLPVectorField

torch.set_num_threads(1)


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("method", ["dopri5", "dopri8", "rk4"])
def test_jump_t_matches_jax(method, adjoint):
    # Jumps off the output times, given out of order: dopri5 takes its
    # stateless stepper, dopri8 the restart driver, rk4 warns.
    kwargs = _kwargs(method)
    kwargs["options"] = dict(kwargs.get("options", {}), jump_t=np.array([3.3, 0.7, 2.25]))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _parity(_smooth(2), np.array([0.0, 2.0, 4.0]), adjoint=adjoint, **kwargs)
    warned = any("ignored by fixed-step methods" in str(w.message) for w in caught)
    assert warned == (method in FIXED)


def test_output_times_gradient_through_the_restart_driver():
    # adaptive_heun restarts at every output time: the clamps to each output
    # time and to the jump carry the output times' gradient, as JAX's do.
    x, z0, w = _smooth(3)
    t = np.array([0.0, 1.7, 4.0])
    kwargs = dict(adjoint=False, method="adaptive_heun", rtol=1e-3, atol=1e-5,
                  options=dict(jump_t=np.array([2.5])))
    proj = np.random.default_rng(2).standard_normal((2, 3, H))
    g_j = jax.grad(lambda tj: jnp.sum(_run(tc, jnp.asarray(x), jnp.asarray(z0), jnp.asarray(w),
                                           tj, **kwargs) * proj))(jnp.asarray(t))
    tt_ = torch.tensor(t, requires_grad=True)
    out = _run(tt, torch.from_numpy(x), torch.from_numpy(z0), torch.from_numpy(w), tt_, **kwargs)
    (out * torch.from_numpy(proj)).sum().backward()
    _close(tt_.grad, g_j, "t")


def test_jump_t_ignored_on_fixed_step_warns():
    x, v, z0 = _rough(seed=45)
    jumps = np.arange(1.0, 9.0)
    for kwargs in (dict(adjoint=False, method="rk4", options=dict(step_size=0.5, jump_t=jumps)),
                   dict(adjoint=True, method="reversible_heun",
                        options=dict(step_size=0.5, jump_t=jumps))):
        with pytest.warns(UserWarning, match="jump_t.*ignored by fixed-step") as caught_t:
            out = _rough_solve(tt, x, v, z0, **kwargs)
        with pytest.warns(UserWarning, match="jump_t.*ignored by fixed-step") as caught_j:
            out_j = _rough_solve(tc, x, v, z0, **kwargs)
        _close(out.detach(), out_j)
        assert sorted(str(w.message) for w in caught_t) == sorted(str(w.message) for w in caught_j)
    # Adaptive methods without step_size honour jump_t: no warning.
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _rough_solve(tt, x, v, z0, adjoint=False, method="dopri5", options=dict(jump_t=jumps))


def test_unsorted_jump_t_matches_sorted():
    # A kinked field: the kinks declared out of order give the sorted mesh,
    # bit for bit, and JAX's.
    ts = np.linspace(0.0, 2.0, 5)
    z0 = np.array([1.0, -0.5])
    cfg = dict(method="dopri5", rtol=1e-6, atol=1e-8)
    outs = []
    for jumps in ([0.5, 1.0, 1.5], [1.5, 0.5, 1.0]):
        out_j, stats_j = jax_integrate.odeint(
            lambda t, z: jnp.where(t < 1.0, z, -0.5 * z), jnp.asarray(z0), ts,
            jax_integrate.SolverConfig(**cfg), jump_t=jnp.asarray(jumps), collect_stats=True)
        out, stats = integrate.odeint(
            lambda t, z: z if t < 1.0 else -0.5 * z, torch.from_numpy(z0), ts,
            integrate.SolverConfig(**cfg), np.array(jumps), collect_stats=True)
        _close(out, out_j)
        assert stats == {k: int(v) for k, v in stats_j.items()}
        outs.append((out, stats))
    assert torch.equal(outs[0][0], outs[1][0]) and outs[0][1] == outs[1][1]


@pytest.mark.parametrize("adjoint", [False, True])
def test_fused_routes_decline_jump_t(adjoint, monkeypatch):
    # An MLP field over a uniform spline: without jump_t K2 (and K9 when per
    # sample) takes the solve; with it no fused route is tried.
    rng = np.random.default_rng(3)
    x = np.linspace(0, 1, 8)[None, :, None] * rng.standard_normal((2, 1, C))
    X = tt.CubicSpline(tt.hermite_cubic_coefficients_with_backward_differences(torch.from_numpy(x)))
    field = MLPVectorField(H, C, 8, dtype=torch.float64)
    z0 = torch.from_numpy(rng.standard_normal((2, H)))
    calls = count_routes(monkeypatch)
    for per_sample in (False, True):
        tt.cdeint(X, field, z0, X.interval, adjoint=adjoint, options=dict(per_sample=per_sample))
        assert calls and calls[-1][1], calls
        calls.clear()
        tt.cdeint(X, field, z0, X.interval, adjoint=adjoint,
                  options=dict(per_sample=per_sample, jump_t=np.array([2.5, 4.0])))
        assert calls == [], calls


def test_reversible_adjoint_with_jump_t_warns_and_takes_k8(monkeypatch):
    rng = np.random.default_rng(5)
    X = tt.CubicSpline(torch.from_numpy(rng.standard_normal((2, 6, 4 * C))))
    field = MLPVectorField(H, C, 8, dtype=torch.float64)
    z0 = torch.from_numpy(rng.standard_normal((2, H)))
    calls = count_routes(monkeypatch)
    with pytest.warns(UserWarning, match=r"ignored by fixed-step methods \(reversible_heun\)"):
        out = tt.cdeint(X, field, z0, X.interval, adjoint=True, method="reversible_heun",
                        options=dict(step_size=1.0, jump_t=np.array([2.5])))
    assert calls == [("try_fused_reversible_heun", True)]
    ref = tt.cdeint(X, field, z0, X.interval, adjoint=True, method="reversible_heun",
                    options=dict(step_size=1.0))
    assert torch.equal(out, ref)
