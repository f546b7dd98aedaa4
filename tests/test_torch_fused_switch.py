"""The fused-kernel switch against the JAX package's, on the CPU in float64.

``solvers.force_fused_kernels(mode)`` and ``solvers.disable_fused_dispatch()``
are the port's ``force_fused_pallas`` and ``disable_fused_dispatch``
(``torchcde_tpu/solvers/fused_pallas.py``).  Each fused route (K1, K2 in
both modes, K8, K9) is counted where it hands its solve to its kernel's
wrapper, which on the CPU runs the kernel's plain version.  With the switch
off each solve is the general path's: bit for bit the solve of the same
field behind a closure, which no route takes.
"""

import threading

import numpy as np
import pytest
import torch

import torchcde_tpu_torch as tt
from torchcde_tpu_torch.solvers import disable_fused_dispatch, force_fused_kernels
from torchcde_tpu_torch.solvers import fused_dopri_kernel as k2
from torchcde_tpu_torch.solvers import fused_dopri_persample_kernel as k9
from torchcde_tpu_torch.solvers import fused_fixed_kernel as k1
from torchcde_tpu_torch.solvers import fused_reversible_kernel as k8
from torchcde_tpu_torch.solvers.fused_fixed import admits_fused
from torchcde_tpu_torch.solvers.terms import MLPVectorField

H, C, W, B, L = 4, 3, 16, 6, 10

# name: (control, cdeint keywords, the kernel the route hands its solve to)
ROUTES = {
    "K1 rk4": ("cubic", dict(method="rk4", step_size=1.0), "K1"),
    "K2 dopri5": ("cubic", dict(method="dopri5"), "K2"),
    "K2 linear-control dopri5": ("linear", dict(method="dopri5"), "K2"),
    "K8 reversible Heun": ("cubic", dict(method="reversible_heun", step_size=1.0), "K8"),
    "K9 per-sample dopri5": ("cubic", dict(method="dopri5", options=dict(per_sample=True)), "K9"),
}
_SOLVES = {"K1": (k1, "fused_fixed_solve"), "K2": (k2, "fused_dopri5_solve"),
           "K8": (k8, "fused_reversible_solve"), "K9": (k9, "fused_dopri5_per_sample_solve")}


@pytest.fixture(autouse=True)
def switch_default():
    force_fused_kernels(None)
    yield
    force_fused_kernels(None)


@pytest.fixture
def counted(monkeypatch):
    """{kernel: the solves handed to its wrapper} since the test began."""
    counts = dict.fromkeys(_SOLVES, 0)
    for name, (module, attr) in _SOLVES.items():
        def counting(*args, _orig=getattr(module, attr), _name=name, **kwargs):
            counts[_name] += 1
            return _orig(*args, **kwargs)

        monkeypatch.setattr(module, attr, counting)
    return counts


def _problem(seed=0):
    """Paths linear in time, on which two float64 adaptive solvers' meshes
    agree (ROADMAP.md section 3), the initial state and the MLP's weights."""
    rng = np.random.default_rng(seed)
    slope = 0.3 * rng.standard_normal((B, 1, C))
    x = rng.standard_normal((B, 1, C)) + slope * np.arange(L)[:, None]
    z0 = rng.standard_normal((B, H))
    w = dict(w1=rng.standard_normal((H, W)) * 0.4, b1=rng.standard_normal(W) * 0.2,
             w2=rng.standard_normal((W, H * C)) * 0.3, b2=rng.standard_normal(H * C) * 0.2)
    return x, z0, w


def _field(w):
    field = MLPVectorField(H, C, W, dtype=torch.float64)
    with torch.no_grad():
        field.linear1.weight.copy_(torch.from_numpy(w["w1"].T))
        field.linear1.bias.copy_(torch.from_numpy(w["b1"]))
        field.linear2.weight.copy_(torch.from_numpy(w["w2"].T))
        field.linear2.bias.copy_(torch.from_numpy(w["b2"]))
    return field


def _solve(route, adjoint, closure=False):
    """The solve's output and the gradients of a loss of it (z0, then the
    field's weights)."""
    control, kw, _ = ROUTES[route]
    x, z0, w = _problem()
    xt = torch.from_numpy(x)
    if control == "linear":
        X = tt.LinearInterpolation(tt.linear_interpolation_coeffs(xt))
    else:
        X = tt.CubicSpline(tt.hermite_cubic_coefficients_with_backward_differences(xt))
    field = _field(w)
    z0 = torch.from_numpy(z0).requires_grad_()
    func = (lambda t, z: field(t, z)) if closure else field
    out = tt.cdeint(X, func, z0, X.interval, adjoint=adjoint, **kw)
    loss = torch.sum(out[..., -1, :] ** 2) + torch.sum(torch.sin(out))
    grads = torch.autograd.grad(loss, [z0] + list(field.parameters()))
    return [out.detach()] + list(grads)


def _same_bits(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("route", list(ROUTES))
def test_off_declines_every_fused_route(route, adjoint, counted):
    """The default takes the route; ``force_fused_kernels(False)`` and an
    active ``disable_fused_dispatch`` decline it, and the solve is the
    general path's (the backsolve under ``adjoint=True``), bit for bit."""
    kernel = ROUTES[route][2]
    _solve(route, adjoint)
    assert counted[kernel] == 1 and sum(counted.values()) == 1
    general = _solve(route, adjoint, closure=True)
    assert sum(counted.values()) == 1  # no route takes a closure
    force_fused_kernels(False)
    off = _solve(route, adjoint)
    force_fused_kernels(None)
    with disable_fused_dispatch():
        disabled = _solve(route, adjoint)
    assert sum(counted.values()) == 1
    assert _same_bits(off, general) and _same_bits(disabled, general)


@pytest.mark.parametrize("route", list(ROUTES))
def test_default_and_true_take_the_same_routes(route, counted):
    """``None`` (the default) and ``True`` give the same solve bit for bit,
    each through its route; the switch set back to None takes it again."""
    kernel = ROUTES[route][2]
    default = _solve(route, True)
    force_fused_kernels(True)
    forced = _solve(route, True)
    force_fused_kernels(False)
    force_fused_kernels(None)
    again = _solve(route, True)
    assert counted[kernel] == 3
    assert _same_bits(default, forced) and _same_bits(default, again)


def test_disable_fused_dispatch_nests_and_stays_in_its_thread():
    field = _field(_problem()[2])
    seen = {}

    def other_thread():
        seen["other"] = admits_fused(field)

    assert admits_fused(field)
    with disable_fused_dispatch():
        assert not admits_fused(field)
        with disable_fused_dispatch():
            assert not admits_fused(field)
        assert not admits_fused(field)  # the outer context is still active
        thread = threading.Thread(target=other_thread)
        thread.start()
        thread.join()
    assert seen["other"] and admits_fused(field)
    # The switch itself holds in every thread.
    force_fused_kernels(False)
    thread = threading.Thread(target=other_thread)
    thread.start()
    thread.join()
    assert not seen["other"] and not admits_fused(field)


def test_the_switch_takes_none_true_or_false():
    with pytest.raises(ValueError, match="None, True or False"):
        force_fused_kernels("off")


@pytest.mark.parametrize("method", ["rk4", "dopri5"])
def test_off_gives_the_jax_default_backsolve_gradients(method):
    """With the switch off, ``adjoint=True`` over an ``MLPVectorField``
    backsolves, as the JAX package's default does off the TPU (its kernels
    decline there): the same gradients, at the backsolve's 1e-7."""
    import jax
    import jax.numpy as jnp

    import torchcde_tpu as tc
    from torchcde_tpu.solvers import fused_pallas
    from torchcde_tpu.solvers.terms import MLPVectorField as JaxField

    kw = dict(method=method, step_size=1.0) if method == "rk4" else dict(method=method)
    x, z0, w = _problem(seed=1)
    coeffs = tc.hermite_cubic_coefficients_with_backward_differences(jnp.asarray(x))

    def loss(z0_, w_):
        X = tc.CubicSpline(coeffs)
        field = JaxField(w_["w1"], w_["b1"], w_["w2"], w_["b2"], H, C)
        out = tc.cdeint(X, field, z0_, X.interval, adjoint=True, **kw)
        return jnp.sum(out[..., -1, :] ** 2) + jnp.sum(jnp.sin(out))

    saved = fused_pallas._FORCE
    fused_pallas.force_fused_pallas(None)  # JAX's default
    try:
        g_z0, g_w = jax.grad(loss, argnums=(0, 1))(
            jnp.asarray(z0), {k: jnp.asarray(v) for k, v in w.items()})
    finally:
        fused_pallas.force_fused_pallas(saved)

    force_fused_kernels(False)
    X = tt.CubicSpline(tt.hermite_cubic_coefficients_with_backward_differences(
        torch.from_numpy(x)))
    field = _field(w)
    z0t = torch.from_numpy(z0).requires_grad_()
    out = tt.cdeint(X, field, z0t, X.interval, adjoint=True, **kw)
    (torch.sum(out[..., -1, :] ** 2) + torch.sum(torch.sin(out))).backward()
    got = {"z0": z0t.grad, "w1": field.linear1.weight.grad.T, "b1": field.linear1.bias.grad,
           "w2": field.linear2.weight.grad.T, "b2": field.linear2.bias.grad}
    expected = dict(g_w, z0=g_z0)
    for name, value in got.items():
        np.testing.assert_allclose(value.numpy(), np.asarray(expected[name]), rtol=1e-7,
                                   atol=1e-12, err_msg=name)
