"""The port's masked fills (K3's plain version and its VJP) against the JAX package.

On the CPU ``masked_fill`` runs the plain version ``masked_fill_scan``; the
kernel is held against it on the card by ``chip_smoke.py``.  The fill is a
pure selection, so values agree exactly; the VJP is a difference of
cumulative sums, summed in the same order on both sides: rtol 1e-12 in
float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchcde_tpu.ops import fill as jfill
from torchcde_tpu_torch.ops import dispatch, fill, fill_kernel

torch.set_num_threads(1)

RTOL, ATOL = 1e-12, 1e-12


def _case(shape, seed, density=0.4):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape), rng.random(shape) < density


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n_values", [1, 2, 5])
@pytest.mark.parametrize("axis", [-1, -2])
def test_masked_fill_matches_jax(reverse, n_values, axis):
    rng = np.random.default_rng(n_values)
    shape = (3, 5, 17)
    observed = rng.random(shape) < 0.35
    values = [rng.standard_normal(shape) for _ in range(n_values)]
    expected = jfill.masked_fill_scan(tuple(map(jnp.asarray, values)), jnp.asarray(observed),
                                      axis=axis, reverse=reverse)
    obs_t = torch.from_numpy(observed)
    vals_t = tuple(map(torch.from_numpy, values))
    for got in (fill.masked_fill_scan(vals_t, obs_t, axis=axis, reverse=reverse),
                fill.masked_fill(vals_t, obs_t, axis=axis, reverse=reverse)):
        assert len(got) == n_values
        for g, e in zip(got, expected):
            np.testing.assert_array_equal(g.numpy(), np.asarray(e))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_masked_fill_vjp_matches_jax(reverse, density):
    rng = np.random.default_rng(3)
    shape = (4, 23)
    observed = rng.random(shape) < density
    observed[1, 5] = True
    values = (rng.standard_normal(shape), rng.standard_normal(shape))
    cotangents = (rng.standard_normal(shape), rng.standard_normal(shape))
    _, vjp = jax.vjp(lambda a, b: jfill.masked_fill((a, b), jnp.asarray(observed),
                                                    reverse=reverse),
                     *map(jnp.asarray, values))
    expected = vjp(tuple(map(jnp.asarray, cotangents)))
    leaves = [torch.from_numpy(v).requires_grad_() for v in values]
    out = fill.masked_fill(tuple(leaves), torch.from_numpy(observed), reverse=reverse)
    got = torch.autograd.grad(out, leaves, tuple(map(torch.from_numpy, cotangents)))
    for g, e in zip(got, expected):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=RTOL, atol=ATOL)


def test_masked_fill_vjp_of_one_leaf():
    # Only the leaves that need a gradient get one; the others stay None.
    values, observed = _case((3, 9), seed=4)
    a = torch.from_numpy(values).requires_grad_()
    b = torch.from_numpy(values * 2)
    ya, yb = fill.masked_fill((a, b), torch.from_numpy(observed))
    (ga,) = torch.autograd.grad((ya * 3 + yb).sum(), [a])
    _, vjp = jax.vjp(lambda v: jfill.masked_fill(v, jnp.asarray(observed)), jnp.asarray(values))
    np.testing.assert_allclose(ga.numpy(), np.asarray(vjp(3 * jnp.ones((3, 9)))[0]),
                               rtol=RTOL, atol=ATOL)


def test_fill_identity_is_the_boundary_entry():
    # Before the first observation a position receives the array's first
    # entry (after the last one, in reverse, its last entry): the scan
    # identity of the JAX code, not the position's own entry.
    v = np.array([5.0, 6.0, 7.0, 8.0, 9.0])
    for mask, reverse, expected in (([0, 0, 1, 0, 1], False, [5, 5, 7, 7, 9]),
                                    ([1, 0, 1, 0, 0], True, [5, 7, 7, 9, 9])):
        mask = np.array(mask, bool)
        jax_out = np.asarray(jfill.masked_fill_scan(jnp.asarray(v), jnp.asarray(mask),
                                                    reverse=reverse))
        np.testing.assert_array_equal(jax_out, expected)
        for fn in (fill.masked_fill_scan, fill.masked_fill):
            got = fn(torch.from_numpy(v), torch.from_numpy(mask), reverse=reverse)
            np.testing.assert_array_equal(got.numpy(), expected)
        # The kernel's wrapper takes the plain version for CPU tensors.
        (got,) = fill_kernel.masked_fill_kernel((torch.from_numpy(v),), torch.from_numpy(mask),
                                                reverse)
        np.testing.assert_array_equal(got.numpy(), expected)


@pytest.mark.parametrize("fill_index", [-2, -1, 0])
def test_forward_and_backward_fill(fill_index):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 40, 3))
    x[rng.random(x.shape) < 0.4] = np.nan
    x[0, :7] = np.nan
    x[1, -5:] = np.nan
    x[2, :, 1] = np.nan
    for jfn, tfn in ((jfill.forward_fill, fill.forward_fill),
                     (jfill.backward_fill, fill.backward_fill)):
        expected = np.asarray(jfn(jnp.asarray(x), fill_index))
        got = tfn(torch.from_numpy(x), fill_index).numpy()
        np.testing.assert_array_equal(got, expected)  # NaN where NaN


@pytest.mark.parametrize("axis", [-1, -2])
def test_observed_indices(axis):
    _, observed = _case((5, 11), seed=6, density=0.3)
    obs = torch.from_numpy(observed)
    np.testing.assert_array_equal(fill.prev_observed_index(obs, axis).numpy(),
                                  np.asarray(jfill.prev_observed_index(jnp.asarray(observed), axis)))
    np.testing.assert_array_equal(fill.next_observed_index(obs, axis).numpy(),
                                  np.asarray(jfill.next_observed_index(jnp.asarray(observed), axis)))


def test_dispatch_rule_on_the_cpu():
    # CPU tensors never go to a kernel; bf16 enters the kernels as float32.
    x = torch.zeros(3, 4)
    assert not dispatch.runs_kernel(x)
    assert not dispatch.runs_kernel(x.double(), x > 0)
    (up,), restore = dispatch.upcast_kernel_operands(x.bfloat16())
    assert up.dtype == torch.float32 and restore(up).dtype == torch.bfloat16
    (same,), restore = dispatch.upcast_kernel_operands(x.double())
    assert same.dtype == torch.float64 and restore(same) is same
