"""Per-sample stepping with the other adaptive methods and with ``jump_t``.

``options={'per_sample': True}`` with bosh3, dopri8 (the restart driver) and
fehlberg2, and dopri5 with ``jump_t``, against the JAX package's per-sample
path in float64 on the CPU: the port runs the lanes in one lockstep solve of
the general integrator (K9 takes dopri5 without jumps only), the JAX
package vmaps a one-sample solve.  Values within 1e-9 of the largest magnitude, per-sample
statistics equal, z0 gradients within 1e-8; paths linear in time
(``tests/test_torch_per_sample.py`` says why).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_per_sample import H, _close, _problem, _torch, jax_general_path  # noqa: F401
import torchcde_tpu as tc
import torchcde_tpu_torch as tt

torch.set_num_threads(1)


def _run(ns, x, W, z0, **kwargs):
    lib, tanh = (tc, jnp.tanh) if ns == "jax" else (tt, torch.tanh)
    X = lib.CubicSpline(lib.hermite_cubic_coefficients_with_backward_differences(x))
    options = dict(per_sample=True)
    if "jump_t" in kwargs:
        jump_t = kwargs.pop("jump_t")
        options["jump_t"] = jnp.asarray(jump_t) if ns == "jax" else jump_t
    return lib.cdeint(X=X, func=lambda s, z: tanh(z)[..., None] * W, z0=z0, t=X.interval,
                      options=options, **kwargs)


@pytest.mark.parametrize("kwargs", [
    dict(method="bosh3"),
    dict(method="dopri8", jump_t=np.array([2.5, 6.0])),
    dict(method="dopri5", jump_t=np.array([6.0, 2.5])),
])
def test_per_sample_values_and_stats_match_jax(kwargs):
    x, W, z0 = _problem(batch_shape=(4,), length=8, spread=0.3)
    out_j, stats_j = _run("jax", *map(jnp.asarray, (x, W, z0)), adjoint=False,
                          return_stats=True, **dict(kwargs))
    out, stats = _run("torch", *_torch(x, W, z0), adjoint=False, return_stats=True,
                      **dict(kwargs))
    assert out.shape == (4, 2, H)
    _close(out, out_j, 1e-9)
    for name, value in stats_j.items():
        np.testing.assert_array_equal(stats[name].numpy(), np.asarray(value), err_msg=name)


@pytest.mark.parametrize("adjoint", [False, True])
def test_per_sample_gradients_of_fehlberg2_match_jax(adjoint):
    x, W, z0 = _problem(batch_shape=(3,), length=6, spread=0.3)
    proj = np.random.default_rng(4).standard_normal((3, H))
    g_j = jax.grad(lambda z: jnp.sum(_run("jax", jnp.asarray(x), jnp.asarray(W), z,
                                          adjoint=adjoint, method="fehlberg2")[..., -1, :]
                                     * proj))(jnp.asarray(z0))
    z = torch.tensor(z0, requires_grad=True)
    out = _run("torch", *_torch(x, W), z, adjoint=adjoint, method="fehlberg2")
    (out[..., -1, :] * torch.from_numpy(proj)).sum().backward()
    _close(z.grad, g_j, 1e-8, "z0")
