"""The rest of the solver surface of the port against the JAX package.

Every method name of the JAX package in float64 on the CPU: the same inputs,
made from a seed, through both packages.  Values and gradients agree within
1e-8 of their largest magnitude (``RTOL``), and solver statistics are equal.
``parity_case`` is the case of ``tests/test_torch_methods_*.py``; its path is
linear in time, because where a step lands just past a spline knot the error
estimate magnifies rounding and two float64 implementations' adaptive meshes
part (PERF.md, PR 2).  The mirrors of the JAX package's convergence tests
(``tests/test_solver_extras.py``) run its rough spline problems; where a mesh
parts there, the case says so and holds the port to a tight float64 solve
instead.  Beside them stand the routes: K1 admits only its four methods, and
no fused route takes a method outside its own.  ``jump_t``, scipy_solver and
the statistics have files of their own beside this one.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchcde_tpu as tc
import torchcde_tpu_torch as tt
from torchcde_tpu.solvers import fused_pallas
from torchcde_tpu.solvers.runge_kutta import STEPPERS as JAX_STEPPERS
from torchcde_tpu_torch.solvers import fused_fixed
from torchcde_tpu_torch.solvers.runge_kutta import TABLEAUS
from torchcde_tpu_torch.solvers.terms import MLPVectorField

torch.set_num_threads(1)

RTOL = 1e-8  # of the largest magnitude, values and gradients
H, C = 3, 2
FIXED = ("euler", "midpoint", "heun", "heun3", "rk4", "reversible_heun",
         "explicit_adams", "implicit_adams", "fixed_adams")
ALL_METHODS = tuple(JAX_STEPPERS)
ADAPTIVE = tuple(m for m in ALL_METHODS if m not in FIXED)


@pytest.fixture(autouse=True)
def jax_general_path():
    fused_pallas.force_fused_pallas(False)
    yield
    fused_pallas.force_fused_pallas(None)


def _close(got, expected, what=""):
    got, expected = np.asarray(got), np.asarray(expected)
    assert got.shape == expected.shape, what
    scale = max(float(np.abs(expected).max()), 1e-300)
    assert float(np.abs(got - expected).max()) <= RTOL * scale, (
        what, float(np.abs(got - expected).max()), scale)


def _smooth(seed, batch=2, length=5):
    """A path linear in time, z0 and the field's weights."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, 1, C)) + rng.uniform(-1, 1, (batch, 1, C)) * \
        np.arange(length)[None, :, None]
    return [x, rng.random((batch, H)), rng.standard_normal((H, H * C)) * 0.5]


def _run(lib, x, z0, w, t, **kwargs):
    """The field tanh(z W) over Hermite coefficients of x.  The JAX package
    takes jump_t as a JAX array (its adjoint negates it)."""
    if lib is tc:
        tanh, X = jnp.tanh, tc.CubicSpline(tc.hermite_cubic_coefficients_with_backward_differences(x))
        if "jump_t" in kwargs.get("options", {}):
            kwargs["options"] = dict(kwargs["options"], jump_t=jnp.asarray(kwargs["options"]["jump_t"]))
    else:
        tanh, X = torch.tanh, tt.CubicSpline(tt.hermite_cubic_coefficients_with_backward_differences(x))
    func = lambda s, z: tanh(z @ w).reshape(z.shape[:-1] + (H, C))  # noqa: E731
    return lib.cdeint(X, func, z0, t, **kwargs)


def _parity(arrays, t, **kwargs):
    """Values, stats (adjoint=False) and the gradients of sum(out * proj)
    with respect to x, z0 and W through both packages."""
    stats = not kwargs.get("adjoint", True)
    proj = np.random.default_rng(11).standard_normal(arrays[1].shape[:-1] + (len(t), H))

    def loss(*a):
        out = _run(tc, *a, t, return_stats=stats, **kwargs)
        out, st = out if stats else (out, None)
        return jnp.sum(out * proj), (out, st)

    (_, (out_j, stats_j)), grads_j = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        *[jnp.asarray(a) for a in arrays])
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = _run(tt, *leaves, t, return_stats=stats, **kwargs)
    out, stats_t = out if stats else (out, None)
    (out * torch.from_numpy(proj)).sum().backward()
    _close(out.detach(), out_j, "values")
    assert np.isfinite(np.asarray(out_j)).all()
    for name, leaf, g in zip(("x", "z0", "W"), leaves, grads_j):
        _close(leaf.grad, g, name)
    if stats:
        assert stats_t == {k: int(v) for k, v in stats_j.items()}
    return out.detach(), stats_t


def _kwargs(method):
    if method in FIXED:
        return dict(method=method, options=dict(step_size=0.5))
    return dict(method=method, rtol=1e-3, atol=1e-5)


def parity_case(method, adjoint):
    """One method of the JAX package through both packages' cdeint, values,
    stats and gradients (the cases of ``tests/test_torch_methods_*.py``)."""
    _parity(_smooth(1), np.array([0.0, 1.5, 4.0]), adjoint=adjoint, **_kwargs(method))


def _rough(draw=0, seed=None):
    """tests/test_solver_extras.py's problem, Hermite over N(0, 1) data and a
    sigmoid field plus a constant: its draw-th draw from that module's
    generator (seed 41), or the first from ``seed``."""
    rng = np.random.default_rng(41 if seed is None else seed)
    for _ in range(draw + 1):
        x, v, z0 = rng.standard_normal((2, 10, 2)), rng.random((1, 1, 2)), rng.random((2, 3))
    return x, v, z0


def _rough_solve(lib, x, v, z0, **kwargs):
    if lib is tc:
        X = tc.CubicSpline(tc.hermite_cubic_coefficients_with_backward_differences(jnp.asarray(x)))
        v_ = jnp.asarray(v)
        if "jump_t" in kwargs.get("options", {}):
            kwargs["options"] = dict(kwargs["options"], jump_t=jnp.asarray(kwargs["options"]["jump_t"]))
        out = tc.cdeint(X, lambda t, z: jax.nn.sigmoid(z)[..., None] + v_, jnp.asarray(z0),
                        X.interval, **kwargs)
        return jax.tree_util.tree_map(np.asarray, out)
    X = tt.CubicSpline(tt.hermite_cubic_coefficients_with_backward_differences(torch.from_numpy(x)))
    v_ = torch.from_numpy(v)
    return tt.cdeint(X, lambda t, z: torch.sigmoid(z)[..., None] + v_, torch.from_numpy(z0),
                     X.interval, **kwargs)


def _both(x, v, z0, **kwargs):
    return _rough_solve(tc, x, v, z0, **kwargs), _rough_solve(tt, x, v, z0, **kwargs)


@functools.lru_cache(maxsize=None)
def _reference(seed):
    """The JAX tests' rk4 reference of ``_rough(seed=seed)``, at step 0.005."""
    return _rough_solve(tt, *_rough(seed=seed), adjoint=False, method="rk4",
                        options=dict(step_size=0.005))


@functools.lru_cache(maxsize=None)
def _tight(seed):
    """A tight float64 solve of ``_rough(seed=seed)``, for where adaptive
    meshes part."""
    return _rough_solve(tt, *_rough(seed=seed), adjoint=False, method="dopri5", rtol=1e-10,
                        atol=1e-12)


def test_bosh3_converges():
    x, v, z0 = _rough(0)
    ref_j, ref = _both(x, v, z0, adjoint=False, method="rk4", options=dict(step_size=0.01))
    out_j, out = _both(x, v, z0, adjoint=False, method="bosh3", rtol=1e-6, atol=1e-8)
    _close(ref, ref_j)
    _close(out, out_j)  # bosh3's mesh holds on this problem
    assert np.allclose(out.numpy(), ref.numpy(), atol=1e-4)


def test_jump_t():
    x, v, z0 = _rough(1)
    jumps = np.arange(1.0, 9.0)
    (out_j, stats_j), (out, stats) = _both(x, v, z0, adjoint=False, method="dopri5",
                                           options=dict(jump_t=jumps), return_stats=True)
    assert stats == {k: int(s) for k, s in stats_j.items()}
    _close(out, out_j)  # landing on every knot, the meshes hold
    assert torch.isfinite(out).all() and stats["steps_accepted"] >= 8
    ref = _rough_solve(tt, x, v, z0, adjoint=False, method="rk4", options=dict(step_size=0.01))
    assert float(torch.abs(out - ref).max()) < 1e-3


@pytest.mark.parametrize("method,rtol,atol,tol", [("dopri8", 1e-7, 1e-9, 1e-5),
                                                  ("adaptive_heun", 1e-6, 1e-8, 1e-3),
                                                  ("fehlberg2", 1e-6, 1e-8, 1e-3)])
def test_extra_adaptive_methods_converge(method, rtol, atol, tol):
    # On this rough spline the adaptive meshes of the port and the JAX
    # package part (a step straddles a knot): the port is held to the rk4
    # reference at the JAX test's tolerance and to a tight float64 solve.
    x, v, z0 = _rough(seed=43)
    out = _rough_solve(tt, x, v, z0, adjoint=False, method=method, rtol=rtol, atol=atol)
    assert np.allclose(out.numpy(), _reference(43).numpy(), atol=tol)
    assert float(torch.abs(out - _tight(43)).max()) < tol


@pytest.mark.parametrize("method", ["explicit_adams", "implicit_adams", "fixed_adams"])
def test_adams_methods_converge(method):
    x, v, z0 = _rough(seed=7)
    ref = _reference(7)
    errs = []
    for h in (0.1, 0.0125):
        out_j, out = _both(x, v, z0, adjoint=False, method=method, options=dict(step_size=h))
        _close(out, out_j)  # fixed steps: the same mesh
        errs.append(float(torch.abs(out - ref).max()))
    assert errs[1] < errs[0] / 16
    assert errs[1] < 5e-4


@pytest.mark.parametrize("method,kwargs,tol", [
    ("explicit_adams", dict(options=dict(step_size=0.05)), (1e-3, 5e-4)),
    ("implicit_adams", dict(options=dict(step_size=0.05)), (1e-3, 5e-4)),
    ("dopri8", dict(rtol=1e-5, atol=1e-7), (1e-3, 1e-5)),
])
def test_grad_paths_of_the_new_steppers(method, kwargs, tol):
    # The stateful fixed-step loop (its bootstrap branch) and the restart
    # driver carry gradients under both adjoint modes, which agree within
    # the JAX test's tolerance.  The fixed steps' direct gradients are also
    # JAX's; dopri8's mesh parts on this rough spline, so its are held to
    # the direct gradients of a tight solve.
    x, v, z0 = _rough(seed=44)
    X = tt.CubicSpline(tt.hermite_cubic_coefficients_with_backward_differences(torch.from_numpy(x)))
    v_ = torch.from_numpy(v)

    def grad(adjoint, **kw):
        z = torch.tensor(z0, requires_grad=True)
        out = tt.cdeint(X, lambda t, s: torch.sigmoid(s)[..., None] + v_, z, X.interval,
                        adjoint=adjoint, **kw)
        out[:, -1].sum().backward()
        return z.grad.numpy()

    g_adj, g_dir = grad(True, method=method, **kwargs), grad(False, method=method, **kwargs)
    assert np.isfinite(g_adj).all()
    np.testing.assert_allclose(g_adj, g_dir, rtol=tol[0], atol=tol[1])
    if method in FIXED:
        Xj = tc.CubicSpline(tc.hermite_cubic_coefficients_with_backward_differences(jnp.asarray(x)))
        g_j = jax.grad(lambda z: jnp.sum(tc.cdeint(
            Xj, lambda t, s: jax.nn.sigmoid(s)[..., None] + jnp.asarray(v), z, Xj.interval,
            adjoint=False, method=method, **kwargs)[:, -1]))(jnp.asarray(z0))
        _close(g_dir, g_j)
    else:
        g_tight = grad(False, method="dopri5", rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(g_dir, g_tight, rtol=tol[0], atol=tol[1])


def test_heun3_third_order_convergence():
    x, v, z0 = _rough(seed=46)
    ref = _reference(46)
    errs = []
    for h in (0.4, 0.2, 0.1):
        out_j, out = _both(x, v, z0, adjoint=False, method="heun3", options=dict(step_size=h))
        _close(out, out_j)
        errs.append(float(torch.abs(out - ref).max()))
    assert errs[0] / errs[1] > 5.0 and errs[1] / errs[2] > 5.0, errs


def test_fused_fixed_admits_only_its_four_methods():
    # K1's admission set is JAX's: heun3's stages would fit the kernel, but
    # the JAX package never fuses it.
    assert set(TABLEAUS) == {"euler", "midpoint", "heun", "rk4"}
    rng = np.random.default_rng(0)
    X = tt.CubicSpline(torch.from_numpy(rng.standard_normal((2, 6, 4 * C))))
    field = MLPVectorField(H, C, 8, dtype=torch.float64)
    z0 = torch.from_numpy(rng.standard_normal((2, H)))
    for method in ALL_METHODS:
        out = fused_fixed.try_fused_fixed(X, field, z0, X.interval, method, 1.0)
        assert (out is None) == (method not in TABLEAUS), method


def count_routes(monkeypatch):
    """Records (route, taken) for every fused route that ``cdeint`` tries."""
    calls = []
    cdeint_module = importlib.import_module("torchcde_tpu_torch.solvers.cdeint")
    for name in ("try_fused_dopri5", "try_fused_dopri5_per_sample", "try_fused_fixed",
                 "try_fused_reversible_heun"):
        def wrapper(*args, _original=getattr(cdeint_module, name), _name=name, **kwargs):
            out = _original(*args, **kwargs)
            calls.append((_name, out is not None))
            return out
        monkeypatch.setattr(cdeint_module, name, wrapper)
    return calls


@pytest.mark.parametrize("adjoint", [False, True])
def test_new_methods_take_no_fused_route(adjoint, monkeypatch):
    rng = np.random.default_rng(4)
    x = np.linspace(0, 1, 6)[None, :, None] * rng.standard_normal((2, 1, C))
    X = tt.CubicSpline(tt.hermite_cubic_coefficients_with_backward_differences(torch.from_numpy(x)))
    field = MLPVectorField(H, C, 8, dtype=torch.float64)
    z0 = torch.from_numpy(rng.standard_normal((2, H)))
    calls = count_routes(monkeypatch)
    for method in ("heun3", "bosh3", "dopri5_nofsal", "dopri8", "adaptive_heun", "fehlberg2",
                   "explicit_adams", "implicit_adams", "fixed_adams"):
        tt.cdeint(X, field, z0, X.interval, adjoint=adjoint, **_kwargs(method))
        assert not any(taken for _name, taken in calls), (method, calls)
