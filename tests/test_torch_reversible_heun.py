"""The port's reversible Heun against the JAX package, on the CPU in float64.

A vector field that is not an ``MLPVectorField`` takes the plain paths on
both sides: the stepper through ``odeint`` with ``adjoint=False``, and the
exact inverse-map adjoint (``reversible_heun_solve``) with ``adjoint=True``.
Values are held to rtol 1e-10 and gradients to 1e-9 (the same steps, summed
in another order); inside the port the adjoint equals direct backpropagation
through the stepper to 1e-11, as the JAX package's own tests hold it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import torchcde_tpu as tc
import torchcde_tpu_torch as tt
from torchcde_tpu.solvers.reversible_adjoint import _n_steps, _rev_heun
from torchcde_tpu.solvers.terms import make_cde_rhs as jax_cde_rhs

torch.set_num_threads(1)


class Field(nn.Module):
    """sigmoid(z) + v, broadcast over the input channels."""

    def __init__(self, v):
        super().__init__()
        self.v = nn.Parameter(torch.from_numpy(v))

    def forward(self, t, z):
        return torch.sigmoid(z)[..., None] + self.v


def _jax_field(v):
    return lambda t, z: jax.nn.sigmoid(z)[..., None] + v


def _problem(batch, length, channels, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((batch, length, channels)), rng.random((1, 1, channels)),
            rng.random((batch, channels)))


def _assert_close(got, expected, rtol, name):
    # atol is a tenth of rtol relative to the largest magnitude: an entry that
    # cancels to near zero keeps the rounding of its largest terms.
    expected = np.asarray(expected)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, expected, rtol=rtol,
                               atol=rtol * 0.1 * float(np.abs(expected).max()), err_msg=name)


def _jax_run(path, v, z0, t, **kwargs):
    """The JAX cdeint's values and its gradients of sum(out ** 2) to path, v, z0."""

    def run(path_, v_, z0_):
        X = tc.CubicSpline(tc.natural_cubic_coeffs(path_))
        return tc.cdeint(X, _jax_field(v_), z0_, t, **kwargs)

    args = tuple(jnp.asarray(a) for a in (path, v, z0))
    grads = jax.grad(lambda *a: jnp.sum(run(*a) ** 2), argnums=(0, 1, 2))(*args)
    return np.asarray(run(*args)), grads


def _torch_run(path, v, z0, t, **kwargs):
    """The port's cdeint, and its gradients of sum(out ** 2) to path, v, z0."""
    field = Field(v)
    pt = torch.from_numpy(path).requires_grad_()
    zt = torch.from_numpy(z0).requires_grad_()
    X = tt.CubicSpline(tt.natural_cubic_coeffs(pt))
    out = tt.cdeint(X, field, zt, t, **kwargs)
    (out ** 2).sum().backward()
    return out.detach(), (pt.grad, field.v.grad, zt.grad)


def _compare(path, v, z0, t, **kwargs):
    out_j, grads_j = _jax_run(path, v, z0, t, **kwargs)
    out_t, grads_t = _torch_run(path, v, z0, t, **kwargs)
    assert out_t.shape == out_j.shape
    _assert_close(out_t, out_j, 1e-10, "solution")
    for name, got, expected in zip(["path", "v", "z0"], grads_t, grads_j):
        _assert_close(got, expected, 1e-9, name)


@pytest.mark.parametrize("t, step", [
    (np.array([0.3, 2.75, 8.5]), 0.5),   # off the knots, clamped last steps
    (np.array([0.0, 4.5, 9.0]), 0.5),
    (np.array([0.0, 1.3, 4.75, 8.0]), None),  # one step per interval
])
def test_stepper_matches_jax(t, step):
    path, v, z0 = _problem(2, 10, 3, 0)
    _compare(path, v, z0, t, adjoint=False, method="reversible_heun", step_size=step)


def test_reversible_heun_order():
    # Second order: halving the step cuts the error about 4x.
    path, v, z0 = _problem(1, 10, 2, 1)
    X = tt.CubicSpline(tt.natural_cubic_coeffs(torch.from_numpy(path)))
    f = Field(v)
    z0 = torch.from_numpy(z0)
    with torch.no_grad():
        ref = tt.cdeint(X, f, z0, X.interval, adjoint=False, method="rk4",
                        options=dict(step_size=0.01))
        errs = [float((tt.cdeint(X, f, z0, X.interval, adjoint=False, method="reversible_heun",
                                 step_size=h) - ref).abs().max()) for h in (0.5, 0.25, 0.125)]
    assert errs[1] < errs[0] / 2.5
    assert errs[2] < errs[1] / 2.5


@pytest.mark.parametrize("t, step", [
    (np.array([0.0, 4.5, 9.0]), 0.5),
    (np.array([0.0, 0.6, 3.0, 7.0]), 0.8),  # 1, 3 and 5 steps, the last ones clamped
])
def test_exact_adjoint_matches_jax(t, step):
    path, v, z0 = _problem(2, 10, 3, 2)
    _compare(path, v, z0, t, adjoint=True, method="reversible_heun", step_size=step)


@pytest.mark.parametrize("t, step", [
    (np.array([0.0, 4.5, 9.0]), 0.5),
    (np.array([0.0, 0.65, 3.1, 7.3]), 0.8),  # 1, 4 and 6 steps, the last ones clamped
])
def test_gradient_to_output_times_matches_jax(t, step):
    # The JAX cdeint needs concrete output times here, so its t-gradient is
    # taken through the same custom VJP it calls (reversible_adjoint._rev_heun).
    # No interval is an exact multiple of the step plus rounding: there the
    # last step's clamp, and so the split of its dt cotangent between the
    # interval's two ends, turns on the last bit of t0 + n h.
    path, v, z0 = _problem(2, 10, 3, 3)
    X = tc.CubicSpline(tc.natural_cubic_coeffs(jnp.asarray(path)))
    rhs = jax_cde_rhs(_jax_field(jnp.asarray(v)), X)
    n_per = tuple(_n_steps(t[i], t[i + 1], step) for i in range(len(t) - 1))
    expected = jax.grad(lambda ts: jnp.sum(_rev_heun(lambda s, z, c: rhs(s, z), step, n_per, [],
                                                     jnp.asarray(z0), ts) ** 2))(jnp.asarray(t))

    Xt = tt.CubicSpline(tt.natural_cubic_coeffs(torch.from_numpy(path)))
    ts = torch.from_numpy(t).requires_grad_()
    out = tt.cdeint(Xt, Field(v).requires_grad_(False), torch.from_numpy(z0), ts, adjoint=True,
                    method="reversible_heun", step_size=step)
    (out ** 2).sum().backward()
    _assert_close(ts.grad, expected, 1e-9, "t")


@pytest.mark.parametrize("length, t, step", [
    (10, np.array([0.0, 4.5, 9.0]), 0.5),
    (6, np.linspace(0.0, 5.0, 50), 0.05),    # many output times
    (8, np.array([0.0, 0.6, 3.0, 7.0]), 0.8),  # ragged intervals
])
def test_adjoint_equals_direct_backprop(length, t, step):
    path, v, z0 = _problem(2, length, 3, 4)
    results = [_torch_run(path, v, z0, t, adjoint=adjoint, method="reversible_heun",
                          step_size=step) for adjoint in (True, False)]
    torch.testing.assert_close(results[0][0], results[1][0], rtol=0, atol=1e-12)
    for name, a, d in zip(["path", "v", "z0"], results[0][1], results[1][1]):
        assert float((a - d).abs().max()) < 1e-11, name


@pytest.mark.parametrize("sde_method, native_method", [
    (None, "midpoint"), ("milstein", "euler"), ("euler_heun", "euler"),
    ("reversible_heun", "reversible_heun"),
])
def test_torchsde_backend_aliases(sde_method, native_method):
    # backend="torchsde": the default method is midpoint, milstein and
    # euler_heun step as Euler (a CDE has no diffusion), and dt is step_size.
    path, v, z0 = _problem(1, 8, 2, 5)
    X = tt.CubicSpline(tt.natural_cubic_coeffs(torch.from_numpy(path)))
    f, z0 = Field(v), torch.from_numpy(z0)
    kwargs = {} if sde_method is None else dict(method=sde_method)
    with torch.no_grad():
        sde = tt.cdeint(X, f, z0, X.interval, adjoint=False, backend="torchsde", dt=1.0, **kwargs)
        native = tt.cdeint(X, f, z0, X.interval, adjoint=False, method=native_method,
                           step_size=1.0)
    assert torch.equal(sde, native)


@pytest.mark.parametrize("adjoint", [True, False])
def test_default_step_sizes_match_jax(adjoint):
    # With no step_size, adjoint=True steps at the largest output interval
    # and adjoint=False takes one step per output interval.
    path, v, z0 = _problem(2, 10, 3, 6)
    _compare(path, v, z0, np.array([0.0, 2.0, 2.5, 9.0]), adjoint=adjoint,
             method="reversible_heun")
