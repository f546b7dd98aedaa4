"""Solver statistics and step budgets of every method against the JAX package.

The JAX package's and the port's ``odeint`` on z' = M z in float64 on the
CPU: the declared evaluation counts of every stepper, equal statistics and
values within 1e-8 of their largest magnitude, with fixed steps for every
method and adaptive steps for the adaptive ones; the default budgets of the
dense and the restart drivers (eight times larger below order 3), and the
restart driver's loud NaN when its budget runs out.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_solver_surface import ADAPTIVE, ALL_METHODS, _close  # noqa: F401
from torchcde_tpu.solvers import integrate as jax_integrate
from torchcde_tpu.solvers.runge_kutta import STEPPERS as JAX_STEPPERS
from torchcde_tpu_torch.solvers import integrate
from torchcde_tpu_torch.solvers.runge_kutta import STEPPERS

torch.set_num_threads(1)


_M = np.array([[-0.3, 1.1], [-1.1, -0.3]])
_Z0 = np.array([1.0, -0.5])


def _odeints(method, ts, collect_stats=True, **cfg):
    """The JAX package's and the port's odeint on z' = M z."""
    out_j = jax_integrate.odeint(lambda t, z: z @ jnp.asarray(_M.T), jnp.asarray(_Z0), ts,
                                 jax_integrate.SolverConfig(method=method, **cfg),
                                 collect_stats=collect_stats)
    out_t = integrate.odeint(lambda t, z: z @ torch.from_numpy(_M.T), torch.from_numpy(_Z0), ts,
                             integrate.SolverConfig(method=method, **cfg),
                             collect_stats=collect_stats)
    return out_j, out_t


@pytest.mark.parametrize("method", ADAPTIVE)
def test_nfe_follows_stepper_declaration(method):
    (out_j, stats_j), (out, stats) = _odeints(method, np.asarray([0.0, 3.0]), rtol=1e-5,
                                              atol=1e-7)
    stepper = STEPPERS[method]
    assert (stepper.nfe_per_step, stepper.init_nfe) == (JAX_STEPPERS[method].nfe_per_step,
                                                        JAX_STEPPERS[method].init_nfe)
    assert stats == {k: int(v) for k, v in stats_j.items()}
    assert stats["nfe"] == stepper.init_nfe + 2 + stats["steps_attempted"] * stepper.nfe_per_step
    _close(out, out_j)


@pytest.mark.parametrize("method", ALL_METHODS)
def test_nfe_fixed_step_declaration(method):
    (out_j, stats_j), (out, stats) = _odeints(method, np.linspace(0.0, 2.0, 3), step_size=0.25)
    stepper = STEPPERS[method]
    assert stats == {k: int(v) for k, v in stats_j.items()}
    assert stats["steps_attempted"] == 8
    assert stats["nfe"] == stepper.init_nfe + 8 * stepper.nfe_per_step
    _close(out, out_j)


@pytest.mark.parametrize("method", ["adaptive_heun", "fehlberg2", "bosh3", "dopri8"])
@pytest.mark.parametrize("differentiable", [True, False])
def test_adaptive_budget_matches_jax(method, differentiable, monkeypatch):
    # Methods of order below 3 get eight times the budget; the dense and the
    # restart drivers are given the JAX package's budget.
    seen = {"jax": [], "torch": []}
    for key, module in (("jax", jax_integrate), ("torch", integrate)):
        for name, index in (("_integrate_adaptive_dense", 7), ("_advance_adaptive", 8)):
            def spy(*args, _original=getattr(module, name), _key=key, _index=index, **kwargs):
                seen[_key].append(int(args[_index]))
                return _original(*args, **kwargs)
            monkeypatch.setattr(module, name, spy)
    ts = np.array([0.0, 0.5, 1.0])
    jax_integrate.odeint(lambda t, z: z @ jnp.asarray(_M.T), jnp.asarray(_Z0), ts,
                         jax_integrate.SolverConfig(method=method, knots_hint=40),
                         differentiable=differentiable)
    integrate.odeint(lambda t, z: z @ torch.from_numpy(_M.T), torch.from_numpy(_Z0), ts,
                     integrate.SolverConfig(method=method, knots_hint=40),
                     differentiable=differentiable)
    order = STEPPERS[method].order
    expected = 1024 if differentiable and order >= 4 else 4096 * (8 if order < 3 else 1)
    assert seen["torch"] and set(seen["torch"]) == set(seen["jax"]) == {expected}


def test_exhausted_budget_of_the_restart_driver_is_loud():
    # A budget that runs out poisons the interval's state, and every later
    # interval counts its whole budget of rejections, as the JAX loop does.
    ts = np.linspace(0.0, 3.0, 4)
    (out_j, stats_j), (out, stats) = _odeints("dopri8", ts, max_steps=2, rtol=1e-9, atol=1e-12)
    assert stats == {k: int(v) for k, v in stats_j.items()}
    assert np.array_equal(np.isnan(out.numpy()), np.isnan(np.asarray(out_j)))
    assert torch.isnan(out[1:]).all() and not torch.isnan(out[0]).any()
