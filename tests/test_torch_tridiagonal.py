"""The port's tridiagonal solves (K4's plain versions and VJP) against the JAX package.

Thomas and PCR are the same float64 operations on both sides in the same
order: values rtol 1e-12; gradients 1e-10 (against dense solves, whose
elimination order differs).  One float32 case
runs the JAX kernel itself in interpret mode, at the JAX tests' tolerance
(rtol 2e-4, atol 2e-5: its PCR levels reorder the elimination).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchcde_tpu.ops import tridiagonal as jtri
from torchcde_tpu.ops.tridiagonal_pallas import tridiagonal_solve_pallas
from torchcde_tpu_torch import misc
from torchcde_tpu_torch.ops import tridiagonal, tridiagonal_kernel

torch.set_num_threads(1)

RTOL, ATOL = 1e-12, 1e-12
GRAD_RTOL, GRAD_ATOL = 1e-10, 1e-10


def _system(batch, k, seed, band_batch=None, dtype=np.float64):
    """A diagonally dominant system; bands with their own batch shape (a
    single band broadcasts against every row, as in the spline fit)."""
    rng = np.random.default_rng(seed)
    band_batch = batch if band_batch is None else band_batch
    u = rng.standard_normal(band_batch + (k - 1,))
    l = rng.standard_normal(band_batch + (k - 1,))
    pad = np.zeros(band_batch + (1,))
    d = 1.0 + np.abs(np.concatenate([u, pad], -1)) + np.abs(np.concatenate([pad, l], -1))
    b = rng.standard_normal(batch + (k,))
    return tuple(a.astype(dtype) for a in (b, u, d, l))


CASES = [((3,), 1, None), ((3,), 2, None), ((4,), 9, None), ((2, 3), 17, None),
         ((5,), 33, ()), ((2, 3), 12, (3,))]


@pytest.mark.parametrize("method", ["thomas", "pcr", "auto", "kernel"])
@pytest.mark.parametrize("batch,k,band_batch", CASES)
def test_solve_matches_jax(method, batch, k, band_batch):
    system = _system(batch, k, seed=k, band_batch=band_batch)
    jax_method = {"kernel": "thomas", "auto": "thomas"}.get(method, method)
    expected = jtri.tridiagonal_solve(*map(jnp.asarray, system), method=jax_method)
    got = tridiagonal.tridiagonal_solve(*map(torch.from_numpy, system), method=method)
    assert got.shape == expected.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=RTOL, atol=ATOL)


GRAD_CASES = [((4,), 9, None), ((5,), 33, ()), ((2, 3), 12, (3,))]


def _dense_vjp(system, w):
    """Gradients of sum(w * A^{-1} b) by dense solves, per row: b_bar =
    A^{-T} w, diag_bar = -b_bar x, upper_bar_i = -b_bar_i x_{i+1},
    lower_bar_i = -b_bar_{i+1} x_i; summed over broadcast dimensions."""
    b, u, d, l = system
    shape = np.broadcast_shapes(d.shape, b.shape)
    k = shape[-1]
    off = shape[:-1] + (k - 1,)
    bb, dd = np.broadcast_to(b, shape), np.broadcast_to(d, shape)
    uu, ll = np.broadcast_to(u, off), np.broadcast_to(l, off)
    x, y = np.empty(shape), np.empty(shape)
    for idx in np.ndindex(shape[:-1]):
        A = np.diag(dd[idx]) + np.diag(uu[idx], 1) + np.diag(ll[idx], -1)
        x[idx] = np.linalg.solve(A, bb[idx])
        y[idx] = np.linalg.solve(A.T, w[idx])

    def sum_to(g, target):
        g = g.sum(axis=tuple(range(g.ndim - len(target)))) if g.ndim > len(target) else g
        axes = tuple(i for i, n in enumerate(target) if n == 1 and g.shape[i] != 1)
        return g.sum(axis=axes, keepdims=True) if axes else g

    return (sum_to(y, b.shape), sum_to(-y[..., :-1] * x[..., 1:], u.shape),
            sum_to(-y * x, d.shape), sum_to(-y[..., 1:] * x[..., :-1], l.shape))


@pytest.mark.parametrize("batch,k,band_batch", GRAD_CASES)
def test_thomas_gradients(batch, k, band_batch):
    # Held against the transpose-solve VJP of the JAX kernel (_tp_bwd),
    # evaluated by dense solves.  jax.grad of the JAX Thomas scan is not
    # taken: jaxlib 0.9.0's CPU runtime corrupts memory when it transposes
    # the float64 scan with respect to its bands.
    system = _system(batch, k, seed=k + 1, band_batch=band_batch)
    w = np.random.default_rng(0).standard_normal(batch + (k,))
    expected = _dense_vjp(system, w)
    leaves = [torch.from_numpy(a).requires_grad_() for a in system]
    out = tridiagonal.tridiagonal_solve_thomas(*leaves)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    for name, g, e in zip(("b", "upper", "diagonal", "lower"), got, expected):
        assert g.shape == e.shape, name
        np.testing.assert_allclose(g.numpy(), e, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("batch,k,band_batch", GRAD_CASES)
def test_pcr_gradients_match_jax(batch, k, band_batch):
    # jax.grad of the JAX PCR solve.  Its band gradients are NaN: each level
    # divides by a zero-padded shifted diagonal in the branch its where
    # discards, and the discarded branch's gradient (0 * inf) poisons the
    # sum.  The port reproduces the function and so the NaNs; Thomas, the
    # default, has finite band gradients.
    system = _system(batch, k, seed=k + 1, band_batch=band_batch)
    w = np.random.default_rng(0).standard_normal(batch + (k,))
    expected = jax.grad(lambda *a: jnp.sum(jtri.tridiagonal_solve_pcr(*a) * w),
                        argnums=(0, 1, 2, 3))(*map(jnp.asarray, system))
    leaves = [torch.from_numpy(a).requires_grad_() for a in system]
    out = tridiagonal.tridiagonal_solve_pcr(*leaves)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    np.testing.assert_allclose(got[0].numpy(), _dense_vjp(system, w)[0], rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    for name, g, e in zip(("b", "upper", "diagonal", "lower"), got, expected):
        assert g.shape == e.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)  # NaN where NaN


def test_kernel_wrapper_takes_the_plain_version_on_the_cpu():
    system = tuple(map(torch.from_numpy, _system((3,), 8, seed=2, band_batch=())))
    got = tridiagonal_kernel.tridiagonal_solve_kernel(*system)
    assert torch.equal(got, tridiagonal.tridiagonal_solve_thomas(*system))
    assert tridiagonal_kernel.LAUNCHES == 0


def test_unknown_method_and_shim():
    system = tuple(map(torch.from_numpy, _system((2,), 4, seed=3)))
    with pytest.raises(ValueError, match="Unknown tridiagonal method 'pallas'"):
        tridiagonal.tridiagonal_solve(*system, method="pallas")
    assert misc.tridiagonal_solve is tridiagonal.tridiagonal_solve
    assert misc.tridiagonal_solve_thomas is tridiagonal.tridiagonal_solve_thomas
    assert misc.tridiagonal_solve_pcr is tridiagonal.tridiagonal_solve_pcr
    assert not hasattr(misc, "TupleControl")


def test_matches_the_jax_kernel_in_interpret_mode():
    b, u, d, l = _system((3,), 64, seed=5, dtype=np.float32)
    expected = tridiagonal_solve_pallas(*map(jnp.asarray, (b, u, d, l)), interpret=True)
    got = tridiagonal.tridiagonal_solve(*map(torch.from_numpy, (b, u, d, l)))
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=2e-4, atol=2e-5)
