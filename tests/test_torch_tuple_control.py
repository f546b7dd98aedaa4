"""Tuple states over a ``TupleControl`` in the port against the JAX package.

The port of ``tests/test_cdeint.py::test_tuple_input`` and of
``TupleControl``'s errors, in float64 on the CPU: the same splines, made
from a seed, through both packages, values within 1e-8 of their largest
magnitudes and the same error texts.  Members of different dtypes raise in
both packages.  ``tests/test_torch_tuple_state.py`` holds the gradients of
tuple states against the JAX package's under every kind of solve.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchcde_tpu as tc
import torchcde_tpu_torch as tt
import torchcde_tpu_torch.misc
from torchcde_tpu.solvers import fused_pallas

torch.set_num_threads(1)

RTOL = 1e-8


@pytest.fixture(autouse=True)
def jax_general_path():
    fused_pallas.force_fused_pallas(False)
    yield
    fused_pallas.force_fused_pallas(None)


def _data(seed, smooth, length=10):
    rng = np.random.default_rng(seed)
    if smooth:  # paths linear in time keep the adaptive meshes together
        ramp = np.linspace(0, 1, length)[:, None]
        xa = rng.standard_normal((2, 1, 2)) * ramp + rng.random((2, 1, 2))
        xb = rng.standard_normal((1, 1)) * ramp
    else:
        xa, xb = rng.random((2, length, 2)), rng.random((length, 1))
    return xa, xb, rng.random((2, 3)), rng.random(5)


def _solve(lib, xa, xb, z0a, z0b, fit="natural", **kwargs):
    """tests/test_cdeint.py::test_tuple_input's problem; ``fit="hermite"``
    takes Hermite coefficients in place of the natural cubic fit, whose JAX
    gradient takes long to compile."""
    fit = (lib.natural_cubic_coeffs if fit == "natural"
           else lib.hermite_cubic_coefficients_with_backward_differences)
    if lib is tc:
        sigmoid, tanh, repeat = jax.nn.sigmoid, jnp.tanh, lambda x: jnp.repeat(x, 2, axis=-1)
    else:
        sigmoid, tanh, repeat = torch.sigmoid, torch.tanh, lambda x: x.repeat_interleave(2, -1)
    X = lib.TupleControl(lib.CubicSpline(fit(xa)), lib.CubicSpline(fit(xb)))

    def func(t, z):
        za, zb = z
        return repeat(sigmoid(za)[..., None]), tanh(zb)[..., None]

    return lib.cdeint(X=X, func=func, z0=(z0a, z0b), t=X.interval, **kwargs)


def _close(got, expected, what):
    got, expected = np.asarray(got), np.asarray(expected)
    assert got.shape == expected.shape, what
    scale = float(np.abs(expected).max())
    assert float(np.abs(got - expected).max()) <= RTOL * scale, (what, scale)


def test_tuple_input():
    xa, xb, z0a, z0b = _data(0, smooth=False)
    z0b_t = torch.tensor(z0b, requires_grad=True)
    out = _solve(tt, torch.from_numpy(xa), torch.from_numpy(xb), torch.from_numpy(z0a), z0b_t)
    out[0].sum().backward()
    # The first member's output does not depend on the second's initial state.
    assert z0b_t.grad is not None and torch.all(z0b_t.grad == 0)
    out_j = _solve(tc, *(jnp.asarray(a) for a in (xa, xb, z0a, z0b)))
    for i in range(2):
        _close(out[i].detach(), out_j[i], f"member {i}")


def test_tuple_members_of_two_dtypes_raise():
    xa, xb, z0a, z0b = _data(2, smooth=True)
    with pytest.raises(Exception):
        _solve(tc, jnp.asarray(xa, jnp.float32), jnp.asarray(xb), jnp.asarray(z0a, jnp.float32),
               jnp.asarray(z0b), adjoint=False)
    with pytest.raises(TypeError, match="must share one dtype"):
        _solve(tt, torch.from_numpy(xa).float(), torch.from_numpy(xb),
               torch.from_numpy(z0a).float(), torch.from_numpy(z0b), adjoint=False)


def test_tuple_states_refuse_per_sample_and_scipy():
    xa, xb, z0a, z0b = (torch.from_numpy(a) for a in _data(3, smooth=True))
    with pytest.raises(ValueError, match="needs a tensor state"):
        _solve(tt, xa, xb, z0a, z0b, adjoint=False, options=dict(per_sample=True))
    with pytest.raises(ValueError, match="single tensor state"):
        _solve(tt, xa, xb, z0a, z0b, adjoint=False, method="scipy_solver")


def _spline(lib, x, t=None):
    return lib.CubicSpline(lib.natural_cubic_coeffs(x, t), t)


@pytest.mark.parametrize("lib", [tc, tt], ids=["jax", "torch"])
def test_tuple_control_errors(lib):
    asarray = jnp.asarray if lib is tc else torch.from_numpy
    rng = np.random.default_rng(4)
    a = _spline(lib, asarray(rng.random((10, 2))))
    with pytest.raises(ValueError, match="Expected one or more controls to batch together."):
        lib.TupleControl()
    longer = _spline(lib, asarray(rng.random((10, 2))), np.linspace(0.0, 10.0, 10))
    with pytest.raises(ValueError, match="Can only batch together controls over the same interval."):
        lib.TupleControl(a, longer)
    other = _spline(lib, asarray(rng.random((10, 2))), np.linspace(0.0, 9.0, 10) ** 2 / 9.0)
    X = lib.TupleControl(a, other)
    with pytest.raises(RuntimeError, match="Batch of controls have different grid points."):
        X.grid_points
    same = lib.TupleControl(a, _spline(lib, asarray(rng.random((10, 1)))))
    assert np.array_equal(np.asarray(same.grid_points), np.arange(10.0))
    assert len(same.evaluate(2.5)) == 2 and len(same.derivative(2.5)) == 2


def test_exports():
    assert tt.TupleControl is torchcde_tpu_torch.misc.TupleControl
    assert tt.__version__ == tc.__version__ == "0.3.0"
    assert set(tt.__all__) == set(tc.__all__)


@pytest.mark.parametrize("which", ["derivative", "func", "length"])
def test_tuple_compatability_errors_match_jax(which):
    xa, xb, z0a, z0b = _data(5, smooth=True)
    texts = []
    for lib, asarray in ((tc, jnp.asarray), (tt, torch.from_numpy)):
        A = _spline(lib, asarray(xa))
        X = lib.TupleControl(A, _spline(lib, asarray(xb)))
        z0 = (asarray(z0a), asarray(z0b))
        func = (lambda t, z: (z[0][..., None].repeat_interleave(2, -1) if lib is tt
                              else jnp.repeat(z[0][..., None], 2, -1), z[1][..., None]))
        if which == "derivative":
            X = A
        elif which == "func":
            func = lambda t, z: z[0][..., None]  # noqa: E731
        else:
            z0 = z0 + (asarray(z0b),)
        with pytest.raises(ValueError) as error:
            lib.cdeint(X, func, z0, X.interval, adjoint=False)
        texts.append(str(error.value))
    assert texts[0] == texts[1]
