"""Per-sample adaptive stepping (``options={'per_sample': True}``) against the
JAX package, in float64 on the CPU.

Every contract of ``tests/test_per_sample.py``, held against the JAX
package's own per-sample output: each sample runs its own error norm, PI
controller and accepted steps.  A vector field that is not an
``MLPVectorField`` takes the per-lane general integrator on both sides (the
JAX package vmaps a one-sample solve; the port runs the lanes in one
lockstep solve, ``solvers/per_sample.py``), so the
solutions, the per-sample statistics and the gradients are the same up to
rounding.  The controls are smooth (paths linear in time): on rough controls
two float64 integrators' meshes drift apart (ROADMAP.md section 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchcde_tpu as tc
import torchcde_tpu_torch as tt
from torchcde_tpu.solvers import fused_pallas

torch.set_num_threads(1)

C, H = 3, 4


@pytest.fixture(autouse=True)
def jax_general_path():
    fused_pallas.force_fused_pallas(False)
    yield
    fused_pallas.force_fused_pallas(None)


def _problem(batch_shape=(5,), length=10, seed=12, spread=0.6):
    """Paths linear in time, their slopes spread over magnitudes, a tanh
    field closing over W, and z0."""
    rng = np.random.default_rng(seed)
    batch = int(np.prod(batch_shape))
    x = (rng.standard_normal((batch, 1, C))
         + rng.uniform(-1, 1, (batch, 1, C)) * np.arange(length)[None, :, None])
    x *= (10.0 ** np.linspace(-spread, spread, batch))[:, None, None]
    x = x.reshape(batch_shape + (length, C))
    W = rng.standard_normal((H, C)) * 0.2
    z0 = rng.standard_normal(batch_shape + (H,))
    return x, W, z0


def _run(ns, x, W, z0, t, **kwargs):
    """cdeint through ns (the JAX package or the port) on Hermite coefficients."""
    lib, tanh = (tc, jnp.tanh) if ns == "jax" else (tt, torch.tanh)
    X = lib.CubicSpline(lib.hermite_cubic_coefficients_with_backward_differences(x))
    return lib.cdeint(X=X, func=lambda s, z: tanh(z)[..., None] * W, z0=z0,
                      t=X.interval if t is None else t, method="dopri5",
                      options=dict(per_sample=True), **kwargs)


def _close(got, expected, rtol, name=""):
    expected = np.asarray(expected)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, expected, rtol=rtol,
                               atol=rtol * 0.1 * float(np.abs(expected).max()), err_msg=name)


def _torch(*arrays):
    return [torch.tensor(np.asarray(a), dtype=torch.float64) for a in arrays]


@pytest.mark.parametrize("kwargs", [dict(rtol=1e-6, atol=1e-8, max_steps=4096), {}])
def test_values_and_stats_match_jax(kwargs):
    x, W, z0 = _problem()
    out_j, stats_j = _run("jax", *map(jnp.asarray, (x, W, z0)), None, adjoint=False,
                          return_stats=True, **kwargs)
    out, stats = _run("torch", *_torch(x, W, z0), None, adjoint=False, return_stats=True,
                      **kwargs)
    assert out.shape == out_j.shape == (5, 2, H)
    _close(out, out_j, 1e-9)
    for name, value in stats_j.items():
        assert tuple(stats[name].shape) == (5,)
        np.testing.assert_array_equal(stats[name].numpy(), np.asarray(value), err_msg=name)
    nfe = stats["nfe"].numpy()
    assert nfe.min() < nfe.max()  # each lane's own difficulty


def test_multi_dim_batch_and_output_times():
    x, W, z0 = _problem(batch_shape=(2, 3), length=8)
    t = np.linspace(0.0, 7.0, 7)
    out_j, stats_j = _run("jax", *map(jnp.asarray, (x, W, z0)), t, adjoint=False,
                          rtol=1e-7, atol=1e-9, return_stats=True)
    out, stats = _run("torch", *_torch(x, W, z0), t, adjoint=False, rtol=1e-7, atol=1e-9,
                      return_stats=True)
    assert out.shape == (2, 3, 7, H) and tuple(stats["nfe"].shape) == (2, 3)
    _close(out, out_j, 1e-9)
    np.testing.assert_array_equal(stats["nfe"].numpy(), np.asarray(stats_j["nfe"]))


@pytest.mark.parametrize("adjoint", [False, True])
def test_batched_output_times(adjoint):
    x, W, z0 = _problem(batch_shape=(4,), spread=0.2)
    t_rows = np.stack([np.linspace(0.0, te, 5) for te in (4.0, 5.5, 7.0, 9.0)])
    out_j = _run("jax", *map(jnp.asarray, (x, W, z0, t_rows)), adjoint=adjoint, rtol=1e-7,
                 atol=1e-9)
    out = _run("torch", *_torch(x, W, z0, t_rows), adjoint=adjoint, rtol=1e-7, atol=1e-9)
    assert out.shape == (4, 5, H)
    _close(out, out_j, 1e-9)


@pytest.mark.parametrize("adjoint", [False, True])
def test_gradients_match_jax(adjoint):
    x, W, z0 = _problem(batch_shape=(3,), spread=0.3)
    proj = np.random.default_rng(3).standard_normal((3, H))

    def loss_j(x_, W_, z0_):
        return jnp.sum(_run("jax", x_, W_, z0_, None, adjoint=adjoint)[..., -1, :] * proj)

    grads_j = jax.grad(loss_j, argnums=(0, 1, 2))(*map(jnp.asarray, (x, W, z0)))
    leaves = [t.requires_grad_() for t in _torch(x, W, z0)]
    out = _run("torch", *leaves, None, adjoint=adjoint)
    (out[..., -1, :] * torch.from_numpy(proj)).sum().backward()
    for name, leaf, expected in zip(("x", "W", "z0"), leaves, grads_j):
        _close(leaf.grad, expected, 1e-7 if adjoint else 1e-8, name)


def test_adjoint_matches_direct():
    x, W, z0 = _problem(batch_shape=(3,), spread=0.3)
    grads = []
    for adjoint in (True, False):
        z = torch.tensor(z0, requires_grad=True)
        out = _run("torch", *_torch(x, W), z, None, adjoint=adjoint, rtol=1e-8, atol=1e-10)
        (out[..., -1, :] ** 2).sum().backward()
        grads.append(z.grad.numpy())
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-3, atol=1e-4)


def _error_text(fn):
    with pytest.raises(ValueError) as error:
        fn()
    return str(error.value)


@pytest.mark.parametrize("case", ["fixed method", "step_size", "unbatched state",
                                  "control batch", "batched t", "row order"])
def test_value_errors_match_jax(case):
    x, W, z0 = _problem(batch_shape=(4,), spread=0.2)
    kwargs, t = {}, None
    if case == "fixed method":
        kwargs = dict(method="rk4", step_size=1.0)
    elif case == "step_size":
        kwargs = dict(step_size=0.5)
    elif case == "unbatched state":
        x, z0 = x[0], z0[0]
    elif case == "control batch":
        x = x[:3]
    elif case == "batched t":
        t = np.stack([np.linspace(0.0, 5.0, 3)] * 3)
    else:
        t = np.array([[0.0, 5.0], [0.0, 5.0], [5.0, 2.0], [0.0, 5.0]])

    def run(ns, arrays):
        def call():
            lib = tc if ns == "jax" else tt
            X = lib.CubicSpline(lib.hermite_cubic_coefficients_with_backward_differences(
                arrays[0]))
            tanh = jnp.tanh if ns == "jax" else torch.tanh
            options = dict(per_sample=True)
            if "step_size" in kwargs and kwargs.get("method") == "rk4":
                options["step_size"] = kwargs["step_size"]
            return lib.cdeint(X=X, func=lambda s, z: tanh(z)[..., None] * arrays[1],
                              z0=arrays[2], t=X.interval if t is None else arrays[3],
                              method=kwargs.get("method", "dopri5"), adjoint=False,
                              options=options,
                              **({"step_size": 0.5} if case == "step_size" else {}))
        return call

    arrays = (x, W, z0, np.zeros(1) if t is None else t)
    expected = _error_text(run("jax", [jnp.asarray(a) for a in arrays]))
    assert _error_text(run("torch", _torch(*arrays))) == expected
