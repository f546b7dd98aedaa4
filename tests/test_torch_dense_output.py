"""Adaptive dense output of the port against the JAX package.

The port of ``tests/test_dense_output.py``: the same odeint problems (a
linear system z' = M z with the known solution expm(M t) z0, a field with a
kink at t = 1) through both packages' integrators in float64 on the CPU.
Each case keeps the JAX test's own checks and adds the JAX package's values
(within 1e-8 of their largest magnitude), gradients and statistics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from torchcde_tpu.solvers import integrate as jax_integrate
from torchcde_tpu_torch.solvers.integrate import SolverConfig, odeint

torch.set_num_threads(1)

RTOL = 1e-8
_M = np.array([[-0.4, 1.3, 0.0], [-1.3, -0.4, 0.5], [0.2, -0.1, -0.9]])
_Z0 = np.array([1.0, -0.5, 0.25])


def _rhs(t, z):
    return z @ torch.from_numpy(_M.T)


def _rhs_j(t, z):
    return z @ jnp.asarray(_M.T)


def _true(ts):
    return np.stack([scipy.linalg.expm(_M * float(t)) @ _Z0 for t in np.asarray(ts)])


def _both(ts, cfg, jump_t=None, collect_stats=False):
    """The JAX package's and the port's odeint, the port held to JAX's
    values and statistics."""
    out_j = jax_integrate.odeint(_rhs_j, jnp.asarray(_Z0), jnp.asarray(ts),
                                 jax_integrate.SolverConfig(**cfg),
                                 jump_t=None if jump_t is None else jnp.asarray(jump_t),
                                 collect_stats=collect_stats)
    out = odeint(_rhs if jump_t is None else _kinked, torch.from_numpy(_Z0), np.asarray(ts),
                 SolverConfig(**cfg), jump_t, collect_stats=collect_stats)
    if collect_stats:
        (out_j, stats_j), (out, stats) = out_j, out
        assert stats == {k: int(v) for k, v in stats_j.items()}
    out_j = np.asarray(out_j)
    assert float(np.abs(out.numpy() - out_j).max()) <= RTOL * float(np.abs(out_j).max())
    return (out, stats) if collect_stats else out


@pytest.mark.parametrize("method", ["dopri5", "bosh3"])
def test_nfe_independent_of_output_grid(method):
    cfg = dict(method=method, rtol=1e-6, atol=1e-8)
    _, stats2 = _both([0.0, 4.0], cfg, collect_stats=True)
    ts100 = np.linspace(0.0, 4.0, 100)
    out100, stats100 = _both(ts100, cfg, collect_stats=True)
    # The accepted-step sequence never sees the output grid: NFE is identical.
    assert stats100["nfe"] == stats2["nfe"]
    np.testing.assert_allclose(out100.numpy(), _true(ts100), rtol=1e-4, atol=1e-6)


def test_dense_values_match_restarted_solve():
    ts = np.asarray([0.0, 0.013, 0.4, 1.1, 1.10001, 2.718, 4.0])
    out = _both(ts, dict(method="dopri5", rtol=1e-7, atol=1e-9))
    np.testing.assert_allclose(out.numpy(), _true(ts), rtol=1e-5, atol=1e-8)


def test_endpoint_matches_len2_solve():
    # The last row is the integrator's own state (theta = 1 gives z1).
    cfg = dict(method="dopri5", rtol=1e-6, atol=1e-8)
    end2 = _both([0.0, 4.0], cfg)
    end100 = _both(np.linspace(0.0, 4.0, 100), cfg)
    np.testing.assert_allclose(end2[-1].numpy(), end100[-1].numpy(), rtol=1e-12)


def test_grads_flow_through_dense_output():
    cfg = dict(method="dopri5", rtol=1e-6, atol=1e-8)
    ts = np.linspace(0.0, 2.0, 7)

    def loss(z0):
        return torch.sum(odeint(_rhs, z0, ts, SolverConfig(**cfg))[1:] ** 2)

    z0 = torch.tensor(_Z0, requires_grad=True)
    loss(z0).backward()
    g_j = jax.grad(lambda z: jnp.sum(jax_integrate.odeint(
        _rhs_j, z, jnp.asarray(ts), jax_integrate.SolverConfig(**cfg))[1:] ** 2))(
        jnp.asarray(_Z0))
    np.testing.assert_allclose(z0.grad.numpy(), np.asarray(g_j), rtol=0,
                               atol=RTOL * float(np.abs(g_j).max()))
    eps = 1e-6
    with torch.no_grad():
        for i in range(3):
            e = torch.zeros(3, dtype=torch.float64)
            e[i] = eps
            z = torch.from_numpy(_Z0)
            fd = (loss(z + e) - loss(z - e)) / (2 * eps)
            np.testing.assert_allclose(float(z0.grad[i]), float(fd), rtol=1e-4, atol=1e-7)


def _kinked(t, z):
    return z if t < 1.0 else -2.0 * z


def test_dense_output_with_jumps():
    # A kinked field declared by jump_t: steps land on the kink and the dense
    # output interpolates on either side of it.
    ts = np.asarray([0.0, 0.5, 0.99, 1.0, 1.5, 2.0])
    cfg = dict(method="dopri5", rtol=1e-8, atol=1e-10)
    out_j = jax_integrate.odeint(lambda t, z: jnp.where(t < 1.0, z, -2.0 * z), jnp.asarray([1.0]),
                                 jnp.asarray(ts), jax_integrate.SolverConfig(**cfg),
                                 jump_t=jnp.asarray([1.0]), collect_stats=True)
    out, stats = odeint(_kinked, torch.tensor([1.0], dtype=torch.float64), ts,
                        SolverConfig(**cfg), np.array([1.0]), collect_stats=True)
    assert stats == {k: int(v) for k, v in out_j[1].items()}
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j[0]), rtol=RTOL)
    true = np.where(ts < 1.0, np.exp(ts), np.e * np.exp(-2.0 * (ts - 1.0)))
    np.testing.assert_allclose(out.numpy()[:, 0], true, rtol=1e-6)


def test_fixed_step_count_not_padded():
    _, stats = _both([0.0, 1.0, 2.0], dict(method="rk4", step_size=0.25), collect_stats=True)
    assert stats["steps_attempted"] == 8
    assert stats["nfe"] == 8 * 4


def test_dopri8_midstep_output_at_full_order():
    # Methods of order above 5 land on every output time: a mid-step read of
    # the quartic would lower dopri8's order.
    ts = np.linspace(0.0, 4.0, 23)
    out = _both(ts, dict(method="dopri8", rtol=1e-7, atol=1e-9))
    np.testing.assert_allclose(out.numpy(), _true(ts), rtol=1e-7, atol=1e-8)


def test_dopri8_clamped_outputs_cost_at_most_len_ts_extra_steps():
    cfg = dict(method="dopri8", rtol=1e-7, atol=1e-9)
    _, stats2 = _both([0.0, 4.0], cfg, collect_stats=True)
    _, stats23 = _both(np.linspace(0.0, 4.0, 23), cfg, collect_stats=True)
    assert stats23["steps_accepted"] <= stats2["steps_accepted"] + 23
