"""The port's host runtime (C++ through ctypes) against the JAX package's and the port's own ops.

Mirrors ``tests/test_native.py`` on the CPU, in float32 and float64 at its
tolerances, against the JAX functions and against the port's torch
functions; and holds the port's library and the JAX package's, built from
the same source with the same flags, equal bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchcde_tpu as tc
import torchcde_tpu_torch as tt
from torchcde_tpu import native as jax_native
from torchcde_tpu.interpolation.linear import _fill_missing_linear
from torchcde_tpu.ops.fill import forward_fill as jax_forward_fill
from torchcde_tpu.ops.logsignature import lyndon_words as jax_lyndon
from torchcde_tpu.ops.logsignature import windowed_logsignatures as jax_windowed
from torchcde_tpu.ops.tridiagonal import tridiagonal_solve_thomas
from torchcde_tpu_torch import native
from torchcde_tpu_torch.interpolation.linear import _fill_missing_linear as tt_fill_missing_linear
from torchcde_tpu_torch.ops import fill as tt_fill
from torchcde_tpu_torch.ops import logsignature as tt_logsignature
from torchcde_tpu_torch.ops.tridiagonal import tridiagonal_solve_thomas as tt_thomas

rng = np.random.default_rng(11)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _times(length, dtype=np.float64):
    return (np.sort(rng.random(length)) * 7 + 0.01 * np.arange(length)).astype(dtype)


def test_available_and_built_under_the_port():
    assert native.available()
    path = native.library_path()
    assert path.exists()
    assert path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parent.name == "torchcde_tpu_torch"
    assert native.BUILD_DIR.name == "_build"
    assert native.SRC.parent.parent.parent.name == "torchcde_tpu_torch"


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_thomas(dtype):
    b = rng.standard_normal((32, 50)).astype(dtype)
    d = (rng.standard_normal((32, 50)) + 5.0).astype(dtype)
    u = rng.standard_normal((32, 49)).astype(dtype)
    l = rng.standard_normal((32, 49)).astype(dtype)
    x = native.thomas_solve(b, u, d, l)
    tol = 1e-4 if dtype == np.float32 else 1e-10
    xr = np.asarray(tridiagonal_solve_thomas(jnp.asarray(b), jnp.asarray(u), jnp.asarray(d),
                                             jnp.asarray(l)))
    assert x.dtype == dtype
    assert np.allclose(x, xr, atol=tol)
    xt = tt_thomas(_t(b), _t(u), _t(d), _t(l)).numpy()
    assert np.allclose(x, xt, atol=tol)


def test_forward_fill():
    x = rng.standard_normal((4, 20, 3))
    x[rng.random(x.shape) < 0.3] = np.nan
    ours = native.forward_fill(x)
    assert np.allclose(ours, np.asarray(jax_forward_fill(jnp.asarray(x))), equal_nan=True)
    assert np.allclose(ours, tt_fill.forward_fill(_t(x)).numpy(), equal_nan=True)


def test_linear_infill():
    x = rng.standard_normal((4, 20, 3))
    x[rng.random(x.shape) < 0.3] = np.nan
    x[1, :, 2] = np.nan  # all-NaN channel
    t = _times(20)
    ours = native.linear_infill(t, x)
    assert np.allclose(ours, np.asarray(_fill_missing_linear(jnp.asarray(t), jnp.asarray(x))),
                       atol=1e-12)
    assert np.allclose(ours, tt_fill_missing_linear(_t(t), _t(x)).numpy(), atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_coefficient_kernels(dtype):
    # float64 on the JAX test's irregular times, whose close knots give
    # coefficients up to ~1e5; float32 on times at least 0.5 apart, as a
    # loader's grid is (close knots leave float32 fits 1e-6 apart).
    x = rng.standard_normal((4, 20, 3)).astype(dtype)
    if dtype == np.float64:
        t, tol = _times(20), 1e-9
    else:
        t, tol = (np.arange(20) + 0.5 * rng.random(20)).astype(dtype), 1e-5
    dense = native.natural_cubic_dense(t, x)
    hermite = native.hermite_coeffs(t, x)
    assert dense.dtype == hermite.dtype == dtype
    for ref in (np.asarray(tc.natural_cubic_coeffs(jnp.asarray(x), jnp.asarray(t))),
                tt.natural_cubic_coeffs(_t(x), _t(t)).numpy()):
        assert np.allclose(dense, ref, atol=tol), np.abs(dense - ref).max()
    jax_hermite = tc.hermite_cubic_coefficients_with_backward_differences(
        jnp.asarray(x), jnp.asarray(t))
    tt_hermite = tt.hermite_cubic_coefficients_with_backward_differences(_t(x), _t(t))
    for ref in (np.asarray(jax_hermite), tt_hermite.numpy()):
        assert np.allclose(hermite, ref, atol=tol), np.abs(hermite - ref).max()


def test_lyndon():
    for c in (2, 3, 4):
        for d in (1, 2, 3):
            words = native.lyndon_words(c, d)
            assert words == jax_lyndon(c, d)
            assert words == tt_logsignature.lyndon_words(c, d)


def test_end_to_end_native_preprocessing():
    """Native coefficients feed the port's solve directly (the loader's pattern)."""
    x = rng.standard_normal((8, 30, 3)).astype(np.float32)
    t = np.arange(30, dtype=np.float32)
    coeffs = native.hermite_coeffs(t, x)
    X = tt.CubicSpline(_t(coeffs), _t(t))
    out = tt.cdeint(X, lambda tt_, z: torch.tanh(z)[..., None] * torch.ones(8, 2, 3),
                    torch.zeros(8, 2), X.interval, adjoint=False, method="rk4")
    assert out.dtype == torch.float32
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_natural_cubic_masked(dtype):
    # The masked C++ kernel against the masked pipelines on NaN-heavy data,
    # with an all-NaN channel and leading and trailing gaps.
    x = rng.standard_normal((6, 24, 3)).astype(dtype)
    x[rng.random(x.shape) < 0.35] = np.nan
    x[1, :, 2] = np.nan
    x[2, :5, 0] = np.nan
    x[3, -6:, 1] = np.nan
    t = np.sort(rng.random(24).astype(dtype)) * 5 + dtype(0.01) * np.arange(24, dtype=dtype)
    ours = native.natural_cubic_masked(t, x)
    atol = 1e-3 if dtype == np.float32 else 1e-9
    ref = np.asarray(tc.natural_cubic_coeffs(jnp.asarray(x), jnp.asarray(t)))
    assert ours.shape == ref.shape
    assert np.allclose(ours, ref, atol=atol), np.abs(ours - ref).max()
    port = tt.natural_cubic_coeffs(_t(x), _t(t)).numpy()
    assert np.allclose(ours, port, atol=atol), np.abs(ours - port).max()


def test_natural_cubic_masked_dense_agrees():
    x = rng.standard_normal((4, 16, 2))
    t = np.arange(16, dtype=np.float64)
    assert np.allclose(native.natural_cubic_masked(t, x), native.natural_cubic_dense(t, x),
                       atol=1e-12)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-4)])
def test_logsig_window_values(dtype, tol):
    x = rng.standard_normal((4, 50, 3)).astype(dtype)
    b = np.asarray([0, 7, 20, 31, 49], np.int64)
    for depth in (1, 2, 3):
        got = native.logsig_window_values(x, b, depth)
        ref = np.asarray(jax_windowed(jnp.asarray(x), depth, b))
        assert got.shape == ref.shape
        assert np.allclose(got, ref, atol=tol, rtol=tol), (depth, np.abs(got - ref).max())
        port = tt_logsignature.windowed_logsignatures(_t(x), depth, b).numpy()
        assert np.allclose(got, port, atol=tol, rtol=tol), (depth, np.abs(got - port).max())


def test_logsig_windows_host_matches_logsig_windows():
    # The whole host pipeline (merged grid, NaN rows, infill, windows, the
    # X(t0) row, cumulative sum) against logsig_windows on an irregular grid.
    x = rng.standard_normal((3, 40, 3))
    x[rng.random(x.shape) < 0.2] = np.nan
    t = np.sort(rng.random(40)) * 11 + 0.01 * np.arange(40)
    got = native.logsig_windows_host(t, x, 3, 2.5)
    ref = np.asarray(tc.logsig_windows(jnp.asarray(x), 3, 2.5, jnp.asarray(t)))
    assert got.shape == ref.shape
    assert np.allclose(got, ref, atol=1e-9), np.abs(got - ref).max()
    port = tt.logsig_windows(_t(x), 3, 2.5, _t(t)).numpy()
    assert np.allclose(got, port, atol=1e-9), np.abs(got - port).max()


def test_loader_logsig_interpolation():
    from torchcde_tpu_torch.data import CoefficientDataLoader

    x = rng.standard_normal((10, 30, 3)).astype(np.float64)
    y = rng.standard_normal(10)
    loader = CoefficientDataLoader(
        x, y, batch_size=5, interpolation="logsig", depth=3, window_length=4.0,
        shuffle=False, device_put=False, num_workers=2)
    batches = list(loader)
    assert len(batches) == 2
    ref = np.asarray(tc.logsig_windows(jnp.asarray(x[:5]), 3, 4.0))
    assert np.allclose(batches[0][0], ref, atol=1e-9)
    assert np.allclose(batches[0][0], tt.logsig_windows(_t(x[:5]), 3, 4.0).numpy(), atol=1e-9)
    with pytest.raises(ValueError, match="depth= and window_length="):
        CoefficientDataLoader(x, y, batch_size=5, interpolation="logsig", device="cpu")


# --- the two libraries, bit for bit ------------------------------------------


@pytest.fixture(scope="module")
def jax_library():
    """The JAX package's library, loaded.  Its loader remembers a failed
    build for the process; a build that raced another process's is retried
    once here, so the comparison never meets the JAX fallback."""
    if not jax_native.available():
        jax_native._build_failed = False
        assert jax_native.available(), "the JAX package's libcdehost did not build"
    return jax_native


def _nan_data(shape, dtype, density=0.3, seed=0):
    gen = np.random.default_rng(seed)
    x = gen.standard_normal(shape).astype(dtype)
    x[gen.random(shape) < density] = np.nan
    return x


BIT_CASES = ["hermite_coeffs", "natural_cubic_dense", "natural_cubic_masked", "linear_infill",
             "forward_fill", "thomas_solve", "logsig_window_values", "logsig_windows_host"]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", BIT_CASES)
def test_libraries_agree_bit_for_bit(jax_library, name, dtype):
    gen = np.random.default_rng(5)
    t = (np.arange(64) + 0.3 * gen.random(64)).astype(dtype)
    dense = gen.standard_normal((33, 64, 3)).astype(dtype)
    if name in ("hermite_coeffs", "natural_cubic_dense"):
        args = (t, dense)
    elif name in ("natural_cubic_masked", "linear_infill"):
        args = (t, _nan_data((33, 64, 3), dtype))
    elif name == "forward_fill":
        args = (_nan_data((33, 64, 3), dtype),)
    elif name == "thomas_solve":
        args = (dense[..., 0], dense[..., 1:, 1], dense[..., 2] + 6, dense[..., 1:, 2])
    elif name == "logsig_window_values":
        args = (dense, np.asarray([0, 10, 31, 50, 63]), 3)
    else:
        args = (t, _nan_data((33, 64, 3), dtype, 0.2), 3, 7.5)
    ours = getattr(native, name)(*args)
    theirs = getattr(jax_library, name)(*args)
    assert ours.dtype == theirs.dtype == dtype
    assert ours.shape == theirs.shape
    np.testing.assert_array_equal(ours.view(np.uint8), theirs.view(np.uint8))


# --- builds and errors -------------------------------------------------------


def test_failed_build_raises_with_no_fallback(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX", "false")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="false failed with exit code 1"):
        native.build()
    assert not native.available()
    x = rng.standard_normal((2, 5, 1))
    for call in (lambda: native.hermite_coeffs(np.arange(5.0), x),
                 lambda: native.natural_cubic_masked(np.arange(5.0), x),
                 lambda: native.lyndon_words(2, 2)):
        with pytest.raises(RuntimeError, match="exit code 1"):
            call()
    assert list(tmp_path.iterdir()) == []  # no library, no leftover temporary


def test_failed_build_carries_the_compiler_output(monkeypatch, tmp_path):
    broken = tmp_path / "cdehost.cpp"
    broken.write_text("int main( { return 0; }\n")
    monkeypatch.setattr(native, "SRC", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed with exit code 1:.*error"):
        native.hermite_coeffs(np.arange(5.0), rng.standard_normal((2, 5, 1)))


def test_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX", "no-such-compiler-cdehost")
    with pytest.raises(RuntimeError, match="no-such-compiler-cdehost was not found"):
        native.build()


def test_library_name_follows_source_and_flags(monkeypatch):
    path = native.library_path()
    assert path.name.startswith("libcdehost_") and path.suffix == ".so"
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    assert native.library_path() != path


def _message(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value), str(info.value)


@pytest.mark.parametrize("case", ["t_shape", "t_2d", "int_dtype", "int_thomas", "int_fill",
                                  "float16"])
def test_errors_carry_the_jax_texts(jax_library, case):
    x = rng.standard_normal((2, 6, 2))
    calls = {
        "t_shape": lambda m: m.hermite_coeffs(np.arange(5.0), x),
        "t_2d": lambda m: m.linear_infill(np.zeros((6, 1)), x),
        "int_dtype": lambda m: m.natural_cubic_dense(np.arange(6), np.ones((2, 6, 2), np.int64)),
        "int_thomas": lambda m: m.thomas_solve(np.ones((2, 4), np.int32), 1, 3, 1),
        "int_fill": lambda m: m.forward_fill(np.ones((2, 4, 1), np.int64)),
        "float16": lambda m: m.natural_cubic_masked(np.arange(6.0), x.astype(np.float16)),
    }
    ours = _message(lambda: calls[case](native))
    theirs = _message(lambda: calls[case](jax_library))
    assert ours == theirs
    assert ours[0] in (ValueError, TypeError)


def test_boundaries_outside_the_path_raise():
    x = rng.standard_normal((2, 10, 2))
    with pytest.raises(ValueError, match="boundaries must be 1-D indices"):
        native.logsig_window_values(x, np.asarray([0, 5, 10]), 2)
    with pytest.raises(ValueError, match="boundaries must be 1-D indices"):
        native.logsig_window_values(x, np.asarray([-1, 5]), 2)
