"""Tuple states in the port against the JAX package, values and gradients.

The problem of ``tests/test_cdeint.py::test_tuple_input`` (two splines in a
``TupleControl``, a tuple field) on paths linear in time, with Hermite
coefficients, in float64 on the CPU: values and the gradients with respect to
both members of z0 and to both controls' data within 1e-8 of their largest
magnitudes, and equal solver statistics, with direct backpropagation and with
the adjoint, fixed and adaptive steps, reversible Heun and ``jump_t``.  The
port packs the members into one flat state, which the integrator treats as
the JAX package treats the tuple.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchcde_tpu as tc
import torchcde_tpu_torch as tt
from test_torch_tuple_control import _close, _data, _solve, jax_general_path  # noqa: F401

torch.set_num_threads(1)


@pytest.mark.parametrize("kwargs", [
    dict(adjoint=False),
    dict(adjoint=True),
    dict(adjoint=False, method="rk4", options=dict(step_size=0.25)),
    dict(adjoint=True, method="rk4", options=dict(step_size=0.25)),
    dict(adjoint=True, method="reversible_heun", options=dict(step_size=0.25)),
    dict(adjoint=False, method="bosh3", options=dict(jump_t=np.array([0.5, 4.5]))),
])
def test_tuple_state_matches_jax(kwargs):
    arrays = _data(1, smooth=True, length=5)
    stats = not kwargs["adjoint"]
    jkwargs = dict(kwargs)
    if "jump_t" in kwargs.get("options", {}):
        jkwargs["options"] = dict(jump_t=jnp.asarray(kwargs["options"]["jump_t"]))
    proj = [np.random.default_rng(5).standard_normal((2, 2, 3)),
            np.random.default_rng(6).standard_normal((2, 5))]

    def loss(*a):
        out = _solve(tc, *a, fit="hermite", return_stats=stats, **jkwargs)
        out, st = out if stats else (out, None)
        return jnp.sum(out[0] * proj[0]) + jnp.sum(out[1] * proj[1]), (out, st)

    (_, (out_j, stats_j)), grads_j = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(
        *(jnp.asarray(a) for a in arrays))
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = _solve(tt, *leaves, fit="hermite", return_stats=stats, **kwargs)
    out, stats_t = out if stats else (out, None)
    assert isinstance(out, tuple) and len(out) == 2
    (sum((o * torch.from_numpy(p)).sum() for o, p in zip(out, proj))).backward()
    for i in range(2):
        _close(out[i].detach(), out_j[i], f"member {i}")
    for name, leaf, g in zip(("xa", "xb", "z0a", "z0b"), leaves, grads_j):
        _close(leaf.grad, g, name)
    if stats:
        assert stats_t == {k: int(v) for k, v in stats_j.items()}
