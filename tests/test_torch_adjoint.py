"""The port's adjoint routes against the JAX package, on the CPU in float64.

A vector field that is not an ``MLPVectorField`` takes the backsolve adjoint
on both sides (the JAX package's ``odeint_adjoint``): the same forward solve,
and the same reverse solves of the augmented state, give the same gradients
to z0, the field's parameters, the coefficients and the output times.  The
canonical MLP field takes the fused kernels' route with ``adjoint=True`` as
with ``adjoint=False``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import torchcde_tpu as tc
import torchcde_tpu_torch as tt
from torchcde_tpu.solvers import fused_pallas
from torchcde_tpu_torch.solvers import fused_dopri_kernel as k2
from torchcde_tpu_torch.solvers import fused_fixed_kernel as k1
from torchcde_tpu_torch.solvers.terms import MLPVectorField

torch.set_num_threads(1)

B, L, C, H, W = 4, 9, 3, 6, 16
T_OUT = np.array([0.0, 1.3, 4.75, 8.0])


@pytest.fixture(autouse=True)
def jax_general_path():
    fused_pallas.force_fused_pallas(False)
    yield
    fused_pallas.force_fused_pallas(None)


class Field(nn.Module):
    """The MLP field's math in a module the fused kernels do not take."""

    def __init__(self, p):
        super().__init__()
        self.l1, self.l2 = nn.Linear(H, W).double(), nn.Linear(W, H * C).double()
        with torch.no_grad():
            for layer, w, b in ((self.l1, p["w1"], p["b1"]), (self.l2, p["w2"], p["b2"])):
                layer.weight.copy_(torch.from_numpy(w.T))
                layer.bias.copy_(torch.from_numpy(b))

    def forward(self, t, z):
        return torch.tanh(self.l2(torch.relu(self.l1(z)))).view(z.shape[:-1] + (H, C))

    def grads(self):
        return [self.l1.weight.grad.T, self.l1.bias.grad, self.l2.weight.grad,
                self.l2.bias.grad]


def _problem(seed=1):
    # Paths linear in time keep the controller well conditioned (see
    # test_torch_adaptive.py).
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 1, C)) + rng.uniform(-1, 1, (B, 1, C)) * np.arange(L)[None, :, None]
    p = dict(w1=rng.standard_normal((H, W)) * 0.5, b1=rng.standard_normal(W) * 0.1,
             w2=rng.standard_normal((W, H * C)) * 0.5, b2=rng.standard_normal(H * C) * 0.1,
             z0=rng.standard_normal((B, H)))
    return x, p


def _jax_grads(x, p, t, argnums, **kwargs):
    """Gradients of sum(out * proj) through the JAX package's cdeint."""

    def run(x_, z0, w1, b1, w2, b2, t_):
        X = tc.CubicSpline(tc.hermite_cubic_coefficients_with_backward_differences(x_))

        def func(s, z):
            g = jnp.tanh(jnp.maximum(z @ w1 + b1, 0.0) @ w2 + b2)
            return g.reshape(z.shape[:-1] + (H, C))

        return tc.cdeint(X, func, z0, t_, **kwargs)

    args = tuple(jnp.asarray(a) for a in (x, p["z0"], p["w1"], p["b1"], p["w2"], p["b2"], t))
    out = run(*args)
    proj = np.random.default_rng(8).standard_normal(out.shape)
    grads = jax.grad(lambda *a: jnp.sum(run(*a) * proj), argnums=argnums)(*args)
    return np.asarray(out), proj, [np.asarray(g) for g in grads]


def _torch_grads(x, p, t, proj, **kwargs):
    field = Field(p)
    xt = torch.from_numpy(x).requires_grad_()
    z0 = torch.from_numpy(p["z0"]).requires_grad_()
    X = tt.CubicSpline(tt.hermite_cubic_coefficients_with_backward_differences(xt))
    if "adjoint_params" in kwargs:
        named = {"w1": field.l1.weight, "b1": field.l1.bias}
        kwargs["adjoint_params"] = tuple(named[k] for k in kwargs["adjoint_params"])
    out = tt.cdeint(X, field, z0, t, **kwargs)
    (out * torch.from_numpy(proj)).sum().backward()
    return out.detach().numpy(), [xt.grad, z0.grad] + field.grads()


def _assert_close(got, expected, rtol, name):
    # atol is a tenth of rtol, relative to the largest magnitude: an entry
    # that cancels to near zero keeps the rounding of its largest terms.
    expected = np.asarray(expected)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, expected, rtol=rtol,
                               atol=rtol * 0.1 * float(np.abs(expected).max()), err_msg=name)


@pytest.mark.parametrize("kwargs", [
    dict(method="dopri5"),
    dict(method="dopri5", adjoint_rtol=1e-6, adjoint_atol=1e-8),
    dict(method="rk4", step_size=0.5),
])
def test_backsolve_matches_jax_adjoint(kwargs):
    x, p = _problem()
    out_j, proj, grads_j = _jax_grads(x, p, T_OUT, tuple(range(6)), adjoint=True, **kwargs)
    out_t, grads_t = _torch_grads(x, p, T_OUT, proj, adjoint=True, **kwargs)
    _assert_close(out_t, out_j, 1e-9, "solution")
    grads_t[4] = grads_t[4].T
    for name, got, expected in zip(["x", "z0", "w1", "b1", "w2", "b2"], grads_t, grads_j):
        _assert_close(got, expected, 1e-7, name)


def test_backsolve_gradient_to_output_times_matches_jax():
    x, p = _problem(2)
    _, proj, (grad_t_j,) = _jax_grads(x, p, T_OUT, (6,), adjoint=True)
    # Only t requires grad on either side, so neither integrates adjoints
    # for the field's parameters (they would enter the reverse error norm).
    field = Field(p).requires_grad_(False)
    X = tt.CubicSpline(tt.hermite_cubic_coefficients_with_backward_differences(torch.from_numpy(x)))
    t = torch.from_numpy(T_OUT).requires_grad_()
    out = tt.cdeint(X, field, torch.from_numpy(p["z0"]), t, adjoint=True)
    (out * torch.from_numpy(proj)).sum().backward()
    _assert_close(t.grad, grad_t_j, 1e-7, "t")


def test_adjoint_params_narrow_the_gradients():
    # The JAX package integrates adjoints for the arrays its closure
    # conversion hoists, the ones being differentiated: differentiating only
    # z0, w1 and b1 there is adjoint_params=(w1, b1) here, the same
    # augmented state and so the same reverse solves.
    x, p = _problem()
    _, proj, grads_j = _jax_grads(x, p, T_OUT, (1, 2, 3), adjoint=True)
    _, grads_t = _torch_grads(x, p, T_OUT, proj, adjoint=True, adjoint_params=("w1", "b1"))
    for name, got, expected in zip(["z0", "w1", "b1"], grads_t[1:4], grads_j):
        _assert_close(got, expected, 1e-7, name)
    # Tensors outside adjoint_params receive nothing.
    assert grads_t[0] is None and grads_t[4] is None and grads_t[5] is None


def test_return_stats_with_adjoint_raises():
    X = tt.CubicSpline(torch.zeros(2, L - 1, 4 * C, dtype=torch.float64))
    with pytest.raises(ValueError, match="return_stats=True requires adjoint=False"):
        tt.cdeint(X, Field(_problem()[1]), torch.zeros(2, H, dtype=torch.float64), X.interval,
                  adjoint=True, return_stats=True)


def _mlp(p):
    field = MLPVectorField(H, C, W, dtype=torch.float64)
    with torch.no_grad():
        for layer, w, b in ((field.linear1, p["w1"], p["b1"]), (field.linear2, p["w2"], p["b2"])):
            layer.weight.copy_(torch.from_numpy(w.T))
            layer.bias.copy_(torch.from_numpy(b))
    return field


@pytest.mark.parametrize("kwargs", [dict(method="dopri5"), dict(method="rk4", step_size=1.0)])
def test_mlp_field_takes_the_fused_route_with_adjoint(kwargs):
    # As in the JAX package, adjoint=True sends the MLP field to the fused
    # kernels (on the CPU their plain versions): the same solve and the same
    # gradients as adjoint=False.
    x, p = _problem(3)
    results = []
    k1.reset_launch_counts()
    k2.reset_launch_counts()
    for adjoint in (False, True):
        field = _mlp(p)
        xt = torch.from_numpy(x).requires_grad_()
        X = tt.CubicSpline(tt.hermite_cubic_coefficients_with_backward_differences(xt))
        out = tt.cdeint(X, field, torch.from_numpy(p["z0"]), X.interval, adjoint=adjoint, **kwargs)
        torch.sin(out).sum().backward()
        results.append([out.detach(), xt.grad] + [q.grad for q in field.parameters()])
    for a, b in zip(*results):
        assert torch.equal(a, b)
    assert (k1.FWD_LAUNCHES, k2.FWD_LAUNCHES) == (0, 0)
