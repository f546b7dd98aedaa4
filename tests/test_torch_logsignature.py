"""The port's logsignatures against the JAX package, on the CPU in float64.

The tensor algebra (exp, Chen's product, inverse, log), the prefix scan (the
port's Hillis-Steele scan against ``lax.associative_scan``), the tree
reduction, the Lyndon coordinates and the three routes of
``windowed_logsignatures``, values and gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchcde_tpu.ops import logsignature as jls
from torchcde_tpu_torch.ops import logsignature as tls

torch.set_num_threads(1)

RTOL, ATOL = 1e-10, 1e-12


def _close(got, expected, rtol=RTOL, atol=ATOL):
    if isinstance(got, tuple):
        assert len(got) == len(expected)
        for g, e in zip(got, expected):
            _close(g, e, rtol, atol)
        return
    expected = np.asarray(expected)
    assert tuple(got.shape) == expected.shape
    np.testing.assert_allclose(got.detach().numpy(), expected, rtol=rtol, atol=atol)


def test_channel_counts():
    assert [tls.logsignature_channels(3, d) for d in (1, 2, 3)] == [3, 6, 14]
    assert [tls.logsignature_channels(2, d) for d in (1, 2, 3)] == [2, 3, 5]
    assert tls.logsignature_channels(4, 3) == 4 + 6 + 20


@pytest.mark.parametrize("channels, depth", [(1, 3), (2, 4), (3, 3), (4, 3), (5, 2)])
def test_lyndon_words_match_jax(channels, depth):
    assert tls.lyndon_words(channels, depth) == jls.lyndon_words(channels, depth)
    for k, idx in jls._lyndon_indices(channels, depth).items():
        np.testing.assert_array_equal(tls._lyndon_indices(channels, depth)[k], idx)


def _levels(seed, shape, c, depth):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape + (c**k,)) for k in range(1, depth + 1))


def _both(levels):
    return (tuple(torch.from_numpy(a) for a in levels), tuple(jnp.asarray(a) for a in levels))


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_tensor_algebra_matches_jax(depth):
    c = 3
    v = np.random.default_rng(0).standard_normal((2, 5, c))
    _close(tls.tensor_exp(torch.from_numpy(v), depth), jls.tensor_exp(jnp.asarray(v), depth))
    At, Aj = _both(_levels(1, (2, 5), c, depth))
    Bt, Bj = _both(_levels(2, (2, 5), c, depth))
    _close(tls.chen_product(At, Bt), jls.chen_product(Aj, Bj))
    _close(tls.group_inverse(At), jls.group_inverse(Aj))
    _close(tls.tensor_log(At), jls.tensor_log(Aj))
    _close(tls.lyndon_coordinates(At), jls.lyndon_coordinates(Aj))


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13])
def test_prefix_scan_and_tree_reduction_match_jax(n):
    inc = np.random.default_rng(n).standard_normal((3, n, 2))
    prefix = tls.prefix_signatures(torch.from_numpy(inc), 3)
    _close(prefix, jls.prefix_signatures(jnp.asarray(inc), 3))
    segs_t = tls.tensor_exp(torch.from_numpy(inc), 3)
    segs_j = jls.tensor_exp(jnp.asarray(inc), 3)
    total = tls.chen_reduce(segs_t)
    _close(total, jls.chen_reduce(segs_j))
    _close(total, tuple(p[..., -1, :] for p in prefix))  # both are the whole product


@pytest.mark.parametrize("mode", ["words", "tensor"])
@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_path_logsignature_matches_jax(depth, mode):
    path = np.random.default_rng(depth).standard_normal((2, 9, 3))
    _close(tls.path_logsignature(torch.from_numpy(path), depth, mode),
           jls.path_logsignature(jnp.asarray(path), depth, mode))
    with pytest.raises(ValueError, match="Unknown logsignature mode"):
        tls.path_logsignature(torch.from_numpy(path), depth, "lyndon")


def test_levy_area():
    p = torch.tensor([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0]], dtype=torch.float64)
    np.testing.assert_allclose(tls.path_logsignature(p, 2).numpy(), [1.0, 1.0, 0.5])


# Boundaries for the three routes: uniform windows (a reshape), irregular
# windows (a padded gather), skewed windows and tensor boundaries (the
# prefix scan).
ROUTES = {
    "uniform": (np.array([0, 5, 10, 15, 20]), 21),
    "irregular": (np.array([0, 5, 9, 14]), 15),
    "irregular offset": (np.array([2, 6, 13, 20]), 21),
    "skewed": (np.array([0, 1, 2, 3, 4, 24]), 25),
    "tensor": (torch.tensor([0, 5, 9, 14]), 15),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_windowed_logsignatures_match_jax(route):
    boundaries, length = ROUTES[route]
    path = np.random.default_rng(3).standard_normal((2, length, 3))
    b_j = jnp.asarray(np.asarray(boundaries))
    got = tls.windowed_logsignatures(torch.from_numpy(path), 3, boundaries)
    _close(got, jls.windowed_logsignatures(jnp.asarray(path), 3, b_j))
    # Each window is the logsignature of its own slice of the path.
    b = np.asarray(boundaries)
    for i, (a, e) in enumerate(zip(b[:-1], b[1:])):
        _close(got[..., i, :], jls.path_logsignature(jnp.asarray(path[..., a:e + 1, :]), 3))


@pytest.mark.parametrize("route", ["uniform", "irregular", "tensor"])
def test_windowed_logsignature_gradients_match_jax(route):
    boundaries, length = ROUTES[route]
    rng = np.random.default_rng(4)
    path = rng.standard_normal((2, length, 3))
    nw = len(boundaries) - 1
    weight = rng.standard_normal((2, nw, 14))
    b_np = np.asarray(boundaries)
    b_j = jnp.asarray(b_np) if route == "tensor" else b_np
    expected = jax.grad(lambda p: jnp.sum(jls.windowed_logsignatures(p, 3, b_j) * weight))(
        jnp.asarray(path))
    pt = torch.from_numpy(path).requires_grad_()
    (tls.windowed_logsignatures(pt, 3, boundaries) * torch.from_numpy(weight)).sum().backward()
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(expected), rtol=1e-8, atol=1e-10)
