"""Gradient paths of the port against the JAX package, in float64 on the CPU.

The port of ``tests/test_tricks.py``: gradients must reach the raw path, the
knot times, the tensors a vector field closes over, z0 and the output times,
under direct backpropagation and the adjoints, and they must be the JAX
package's, not merely non-zero.  Beside its cases stand the probes of the
faults that the port once had here: adjoints over a control whose tensors
hang on one another (a linear control's slopes on its knot values, a spline's
rows on a knot tensor), tensors closed over by a plain callable field, output
times on the direct path, fused routes that must decline when the output
times require grad, and the error text of an unknown method.
"""

import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchcde_tpu as tc
import torchcde_tpu_torch as tt
from torchcde_tpu.solvers import fused_pallas
from torchcde_tpu.solvers.terms import MLPVectorField as JaxField
from torchcde_tpu_torch.solvers import fused_dopri, fused_fixed
from torchcde_tpu_torch.solvers.fused_reversible_kernel import try_fused_reversible_heun
from torchcde_tpu_torch.solvers.integrate import SolverConfig
from torchcde_tpu_torch.solvers.terms import MLPVectorField

torch.set_num_threads(1)

H, C, W = 3, 3, 8

JAX = types.SimpleNamespace(lib=tc, sigmoid=jax.nn.sigmoid, asarray=jnp.asarray)
TORCH = types.SimpleNamespace(lib=tt, sigmoid=torch.sigmoid, asarray=torch.as_tensor)


@pytest.fixture(autouse=True)
def jax_general_path():
    fused_pallas.force_fused_pallas(False)
    yield
    fused_pallas.force_fused_pallas(None)


def _sigmoid_field(ns, variable):
    """tests/test_tricks.py's field: it closes over ``variable``."""
    return lambda t, z: ns.sigmoid(z)[..., None] + variable


def _mlp(ns, w1, b1, w2, b2):
    """The canonical MLP field with the given arrays as its weights."""
    if ns is JAX:
        return JaxField(w1, b1, w2, b2, H, C)
    field = MLPVectorField(H, C, W, dtype=torch.float64)
    for layer, weight, bias in ((field.linear1, w1.T, b1), (field.linear2, w2.T, b2)):
        del layer.weight, layer.bias  # the leaves themselves, so autograd reaches them
        layer.weight, layer.bias = weight, bias
    return field


def _weights(rng):
    return [rng.standard_normal((H, W)) * 0.5, rng.standard_normal(W) * 0.1,
            rng.standard_normal((W, H * C)) * 0.5, rng.standard_normal(H * C) * 0.1]


def _compare(run, arrays, rtol, names, seed=8):
    """Values and the gradients of sum(out * proj) with respect to every array,
    through the JAX package and through the port."""
    args_j = [jnp.asarray(a) for a in arrays]
    out_j = np.asarray(run(JAX, *args_j))
    proj = np.random.default_rng(seed).standard_normal(out_j.shape)
    grads_j = jax.grad(lambda *a: jnp.sum(run(JAX, *a) * proj),
                       argnums=tuple(range(len(arrays))))(*args_j)
    leaves = [torch.tensor(np.asarray(a), dtype=torch.float64, requires_grad=True)
              for a in arrays]
    out = run(TORCH, *leaves)
    (out * torch.from_numpy(proj)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), out_j, rtol=1e-9,
                               atol=1e-10 * float(np.abs(out_j).max()))
    for name, leaf, expected in zip(names, leaves, grads_j):
        expected = np.asarray(expected)
        assert leaf.grad is not None, name
        assert np.abs(expected).sum() > 0, name
        np.testing.assert_allclose(leaf.grad.numpy(), expected, rtol=rtol,
                                   atol=rtol * 0.1 * float(np.abs(expected).max()), err_msg=name)


@pytest.mark.parametrize("method,kwargs", [("rk4", {"options": {"step_size": 1.0}}),
                                           ("dopri5", {})])
@pytest.mark.parametrize("adjoint", [True, False])
def test_grad_paths(method, adjoint, kwargs):
    rng = np.random.default_rng(5)
    arrays = [np.linspace(0, 9, 10), rng.random((1, 10, 3)), rng.random((1, 1, 3)),
              rng.random((1, 3)), np.array([0.0, 9.0])]

    def run(ns, t, path, variable, z0, t_out):
        coeffs = ns.lib.natural_cubic_coeffs(path, t)
        X = ns.lib.CubicSpline(coeffs, t)
        z = ns.lib.cdeint(X=X, func=_sigmoid_field(ns, variable), z0=z0, t=t_out,
                          adjoint=adjoint, method=method, rtol=1e-4, atol=1e-6, **kwargs)
        assert z.shape == (1, 2, 3)
        return z[:, 1]

    _compare(run, arrays, 1e-7 if adjoint else 1e-8, ("t", "path", "variable", "z0", "t_out"))


@pytest.mark.parametrize("adjoint", [False, True])
def test_stacked_cdes(adjoint):
    rng = np.random.default_rng(6)
    arrays = [rng.random((1, 20, 2)), rng.random((1, 1, 2)), rng.random((1, 1, 2))]
    z0_1, z0_2 = rng.random((1, 2)), rng.random((1, 2))
    second_t = np.linspace(0, 19, 5)

    def run(ns, first_path, var1, var2):
        first_X = ns.lib.LinearInterpolation(ns.lib.linear_interpolation_coeffs(first_path))
        second_path = ns.lib.cdeint(X=first_X, func=_sigmoid_field(ns, var1),
                                    z0=ns.asarray(z0_1), t=second_t, adjoint=adjoint,
                                    method="rk4", options=dict(step_size=2.5))
        second_X = ns.lib.CubicSpline(ns.lib.natural_cubic_coeffs(second_path, second_t),
                                      second_t)
        return ns.lib.cdeint(X=second_X, func=_sigmoid_field(ns, var2), z0=ns.asarray(z0_2),
                             t=np.array([0.0, 19.0]), adjoint=adjoint, method="rk4",
                             options=dict(step_size=2.5))[:, -1]

    _compare(run, arrays, 1e-7 if adjoint else 1e-8, ("first_path", "var1", "var2"))


def test_adjoint_matches_direct():
    """For a fixed-step solve the backsolve's gradients match direct
    backpropagation to the solver's accuracy, as in the JAX package."""
    rng = np.random.default_rng(7)
    path, variable, z0 = rng.random((2, 10, 3)), rng.random((1, 1, 3)), rng.random((2, 3))

    def grads(adjoint):
        leaves = [torch.tensor(a, requires_grad=True) for a in (path, variable, z0)]
        X = tt.CubicSpline(tt.natural_cubic_coeffs(leaves[0]))
        z = tt.cdeint(X=X, func=_sigmoid_field(TORCH, leaves[1]), z0=leaves[2],
                      t=np.array([0.0, 9.0]), adjoint=adjoint, method="rk4",
                      options=dict(step_size=0.1))
        (z[:, -1] ** 2).sum().backward()
        return [leaf.grad.numpy() for leaf in leaves]

    for ga, gd in zip(grads(True), grads(False)):
        assert np.abs(ga - gd).max() <= 1e-4 * np.abs(gd).max() + 1e-8


@pytest.mark.parametrize("adjoint", [True, False])
def test_detach_trick(adjoint):
    """Whether the output times require grad changes no fixed-step result
    beyond rounding: such times decline the knot-aligned walk, as traced
    times decline it in the JAX package, and take the general integrator."""
    rng = np.random.default_rng(8)
    X = tt.CubicSpline(tt.natural_cubic_coeffs(torch.from_numpy(rng.random((1, 10, 3)))))
    z0 = torch.from_numpy(rng.random((1, 3)))
    variable_grads = []
    for t_grad in (True, False):
        variable = torch.from_numpy(rng.random((1, 1, 3)) * 0 + 0.3).requires_grad_()
        t = torch.tensor([0.0, 9.0], dtype=torch.float64, requires_grad=t_grad)
        z = tt.cdeint(X=X, z0=z0, func=_sigmoid_field(TORCH, variable), t=t, adjoint=adjoint,
                      method="rk4", options=dict(step_size=0.5))
        z[:, -1].sum().backward()
        variable_grads.append(variable.grad)
    torch.testing.assert_close(variable_grads[0], variable_grads[1], rtol=1e-12, atol=1e-14)


# Fault 1: a linear control's slopes are built from its knot values, so both
# hang on the path; the adjoints crashed with "Trying to backward through the
# graph a second time".
# An MLP field takes the backsolve too at fixed steps over a linear control,
# which K1 does not take; adaptive dopri5 over it takes K2's linear mode.
@pytest.mark.parametrize("method,kwargs,mlp", [
    ("euler", dict(step_size=0.5), False), ("midpoint", dict(step_size=0.5), False),
    ("rk4", dict(step_size=0.5), False), ("dopri5", dict(step_size=0.5), False),
    ("dopri5", {}, False), ("rk4", dict(step_size=0.5), True),
])
def test_adjoint_through_a_linear_control_of_a_path(method, kwargs, mlp):
    rng = np.random.default_rng(9)
    x = np.cumsum(rng.standard_normal((2, 6, C)) * 0.3, axis=1)
    arrays = [x, rng.random((1, 1, C)) if not mlp else rng.standard_normal((2, H))] + (
        _weights(rng) if mlp else [])

    def run(ns, path, *rest):
        X = ns.lib.LinearInterpolation(ns.lib.linear_interpolation_coeffs(path))
        if mlp:
            func, z0 = _mlp(ns, *rest[1:]), rest[0]
        else:
            func, z0 = _sigmoid_field(ns, rest[0]), ns.asarray(np.full((2, C), 0.2))
        return ns.lib.cdeint(X=X, func=func, z0=z0, t=np.array([0.0, 2.5, 5.0]), adjoint=True,
                             method=method, **kwargs)

    names = ("path", "z0", "w1", "b1", "w2", "b2") if mlp else ("path", "variable")
    _compare(run, arrays, 1e-7, names)


# Fault 1 with a knot tensor: a spline's rows are fitted on the knot tensor
# that the spline also reads.
@pytest.mark.parametrize("method,kwargs", [
    ("rk4", dict(step_size=0.5)), ("dopri5", {}), ("reversible_heun", dict(step_size=0.5)),
])
def test_adjoint_through_a_knot_tensor(method, kwargs):
    rng = np.random.default_rng(10)
    arrays = [np.array([0.0, 0.8, 2.1, 3.0, 4.2, 5.0]), rng.standard_normal((2, 6, C)) * 0.5,
              rng.standard_normal((2, H))] + _weights(rng)

    def run(ns, knots, x, z0, *weights):
        X = ns.lib.CubicSpline(ns.lib.natural_cubic_coeffs(x, knots), knots)
        return ns.lib.cdeint(X=X, func=_mlp(ns, *weights), z0=z0, t=np.array([0.0, 5.0]),
                             adjoint=True, method=method, **kwargs)

    _compare(run, arrays, 1e-7, ("knots", "x", "z0", "w1", "b1", "w2", "b2"))


# Fault 2: a plain callable's closed-over tensors received no adjoint
# gradient.
@pytest.mark.parametrize("method,kwargs", [("dopri5", {}), ("rk4", dict(step_size=0.5)),
                                           ("reversible_heun", dict(step_size=0.5))])
def test_adjoint_reaches_closed_over_tensors(method, kwargs):
    rng = np.random.default_rng(11)
    coeffs = rng.standard_normal((2, 5, 4 * C)) * 0.3
    arrays = [rng.standard_normal((H, C)) * 0.5, rng.standard_normal((2, H))]

    def run(ns, A, z0):
        X = ns.lib.CubicSpline(ns.asarray(coeffs))
        return ns.lib.cdeint(X, lambda t, z: ns.sigmoid(z)[..., None] * A, z0,
                             np.array([0.0, 2.0, 5.0]), adjoint=True, method=method, **kwargs)

    _compare(run, arrays, 1e-7, ("A", "z0"))


# Fault 3: the output times received no gradient on the direct path.  The
# JAX integrator differentiates the clamped fixed step (its ties split in
# half), and the adaptive loop's dense output through theta and the stage
# times through t0.
#
# The control is a random walk ("walk") or a line in time ("line").  The
# adaptive dopri5 cases integrate the line: on the walk, both integrators
# take the same attempted and accepted steps, but where a step ends just
# past a knot the error estimate magnifies rounding, the two float64 meshes
# drift, and the t gradient differs by ~2e-8 relative (ROADMAP.md section 3,
# "Adaptive meshes drift on rough controls").  The walk stays as its own
# cases at the reference's 1e-6.
OUTPUT_TIME_CASES = [
    ("euler", {}, [0.0, 1.5, 4.0], False, "walk", 1e-8),
    ("euler", dict(step_size=0.4), [0.3, 1.5, 4.25], True, "walk", 1e-8),
    ("midpoint", dict(step_size=0.4), [0.0, 1.5, 3.7], False, "walk", 1e-8),
    ("rk4", dict(step_size=1.0), [0.0, 1.5, 4.0], True, "walk", 1e-8),
    ("rk4", dict(step_size=0.4), [0.3, 1.5, 4.25], False, "walk", 1e-8),
    ("dopri5", {}, [0.3, 1.5, 4.25], False, "line", 1e-8),
    ("dopri5", {}, [0.3, 1.5, 4.25], True, "line", 1e-8),
    ("dopri5", dict(step_size=0.4), [0.0, 1.5, 4.25], False, "walk", 1e-8),
    ("reversible_heun", dict(step_size=0.4), [0.3, 1.5, 4.25], False, "walk", 1e-8),
    ("reversible_heun", {}, [0.0, 1.5, 4.0], True, "walk", 1e-8),
    ("dopri5", {}, [0.3, 1.5, 4.25], False, "walk", 1e-6),
    ("dopri5", {}, [0.3, 1.5, 4.25], True, "walk", 1e-6),
]


@pytest.mark.parametrize(
    "method,kwargs,t_out,linear,control,rtol", OUTPUT_TIME_CASES,
    # The ids keep the form they had before the control and rtol columns.
    ids=[f"{c[0]}-kwargs{i}-t_out{i}-{c[3]}" for i, c in enumerate(OUTPUT_TIME_CASES)])
def test_output_times_gradient_on_the_direct_path(method, kwargs, t_out, linear, control, rtol):
    rng = np.random.default_rng(12)
    x = np.cumsum(rng.standard_normal((2, 6, C)) * 0.3, axis=1)
    if control == "line":  # steep enough that the controller rejects steps
        x = x[:, :1] + (x[:, -1:] - x[:, :1]) * np.linspace(0.0, 3.0, 6)[None, :, None]
    arrays = [np.array(t_out), rng.standard_normal((2, H))] + _weights(rng)

    def run(ns, t, z0, *weights):
        if linear:
            X = ns.lib.LinearInterpolation(ns.lib.linear_interpolation_coeffs(ns.asarray(x)))
        else:
            X = ns.lib.CubicSpline(
                ns.lib.hermite_cubic_coefficients_with_backward_differences(ns.asarray(x)))
        return ns.lib.cdeint(X=X, func=_mlp(ns, *weights), z0=z0, t=t, adjoint=False,
                             method=method, **kwargs)

    _compare(run, arrays, rtol, ("t", "z0", "w1", "b1", "w2", "b2"))


def test_fused_routes_decline_output_times_that_require_grad():
    rng = np.random.default_rng(13)
    X = tt.CubicSpline(tt.hermite_cubic_coefficients_with_backward_differences(
        torch.from_numpy(rng.standard_normal((2, 6, C)))))
    field = _mlp(TORCH, *(torch.from_numpy(w) for w in _weights(rng)))
    z0 = torch.from_numpy(rng.standard_normal((2, H)))
    for grad in (False, True):
        t = torch.tensor([0.0, 2.0, 5.0], dtype=torch.float64, requires_grad=grad)
        routes = (fused_fixed.try_fused_fixed(X, field, z0, t, "rk4", 1.0),
                  try_fused_reversible_heun(X, field, z0, t, 1.0),
                  fused_dopri.try_fused_dopri5(X, field, z0, t, SolverConfig()))
        assert all((r is None) == grad for r in routes)


@pytest.mark.parametrize("kwargs, error, text", [
    (dict(method="foo"), ValueError, "Unrecognised method='foo'; expected one of "),
    (dict(method="rk4", adjoint_method="bar", adjoint=True), ValueError,
     "Unrecognised method='bar'; expected one of "),
    (dict(method="bosh3"), None, None),
    (dict(method="rk4", adjoint_method="dopri8", adjoint=True), None, None),
])
def test_unknown_method_raises_the_jax_error(kwargs, error, text):
    """An unknown name raises the JAX package's error; the last two cases,
    names that the port once refused, run through both packages and agree
    within 1e-8 of the largest magnitude, values and z0 gradients."""
    kwargs = dict(dict(adjoint=False, step_size=1.0), **kwargs)
    if error is None:
        x = np.random.default_rng(9).standard_normal((2, 1, C)) * np.arange(4.0)[:, None]

        def run(ns, z0):
            X = ns.lib.CubicSpline(ns.lib.hermite_cubic_coefficients_with_backward_differences(
                ns.asarray(x)))
            return ns.lib.cdeint(X, _sigmoid_field(ns, ns.asarray(np.full(C, 0.3))), z0,
                                 X.interval, **kwargs)

        z0 = np.random.default_rng(10).standard_normal((2, H))
        out_j = np.asarray(run(JAX, jnp.asarray(z0)))
        g_j = np.asarray(jax.grad(lambda z: jnp.sum(run(JAX, z) ** 2))(jnp.asarray(z0)))
        z = torch.tensor(z0, requires_grad=True)
        out = run(TORCH, z)
        (out ** 2).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), out_j, rtol=0,
                                   atol=1e-8 * np.abs(out_j).max())
        np.testing.assert_allclose(z.grad.numpy(), g_j, rtol=0, atol=1e-8 * np.abs(g_j).max())
        return
    X = tt.CubicSpline(torch.zeros(2, 4, 4 * C, dtype=torch.float64))
    with pytest.raises(error, match=re.escape(text)):
        tt.cdeint(X, lambda t, z: torch.sigmoid(z)[..., None].expand(z.shape + (C,)),
                  torch.zeros(2, H, dtype=torch.float64), X.interval, **kwargs)
    Xj = tc.CubicSpline(jnp.zeros((2, 4, 4 * C)))
    with pytest.raises(ValueError, match=re.escape(text)) as jax_error:
        out = tc.cdeint(Xj, lambda t, z: jnp.broadcast_to(jax.nn.sigmoid(z)[..., None],
                                                          z.shape + (C,)),
                        jnp.zeros((2, H)), Xj.interval, **kwargs)
        jax.grad(lambda z0: jnp.sum(tc.cdeint(
            Xj, lambda t, z: jnp.broadcast_to(jax.nn.sigmoid(z)[..., None], z.shape + (C,)),
            z0, Xj.interval, **kwargs)))(jnp.zeros((2, H)))
        del out
    with pytest.raises(ValueError) as port_error:
        tt.cdeint(X, lambda t, z: torch.sigmoid(z)[..., None].expand(z.shape + (C,)),
                  torch.zeros(2, H, dtype=torch.float64), X.interval, **kwargs)
    assert str(port_error.value) == str(jax_error.value)
