"""The port's prefetching coefficient loader against the JAX package's, on the CPU.

Mirrors ``tests/test_data.py`` with ``device="cpu"``: every route (hermite,
cubic with NaN, linear, logsig), the validation texts, worker order,
``drop_last=False``, exception propagation, the batch order of the JAX
loader for the same seed, and one float64 training step on a loader batch
against JAX's ``make_train_step`` on the JAX loader's batch.
"""

import math
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torchcde_tpu as tc
import torchcde_tpu_torch as tt
from torchcde_tpu.data import CoefficientDataLoader as JaxLoader
from torchcde_tpu.models.neural_cde import NeuralCDEConfig as JaxConfig
from torchcde_tpu.models.neural_cde import init_neural_cde
from torchcde_tpu.models.training import make_train_step as jax_make_train_step
from torchcde_tpu_torch.data import CoefficientDataLoader
from torchcde_tpu_torch.interop import from_jax_params
from torchcde_tpu_torch.models import NeuralCDE, NeuralCDEConfig, make_train_step

torch.set_num_threads(1)
rng = np.random.default_rng(43)


@pytest.fixture(scope="module", autouse=True)
def jax_library():
    """The JAX loader's batches come from its libcdehost.  Its loader
    remembers a failed build for the process; a build that raced another
    process's is retried once here, so the comparisons never meet the JAX
    package's fallback."""
    from torchcde_tpu import native as jax_native

    if not jax_native.available():
        jax_native._build_failed = False
        assert jax_native.available(), "the JAX package's libcdehost did not build"


def _toy_data(n, length=10, channels=2, dtype=np.float32):
    x = rng.standard_normal((n, length, channels)).astype(dtype)
    y = rng.random(n).astype(dtype)
    return x, y


def test_loader_matches_direct_coefficients():
    x = rng.standard_normal((20, 15, 3)).astype(np.float32)
    y = rng.random(20).astype(np.float32)
    loader = CoefficientDataLoader(x, y, batch_size=8, interpolation="hermite",
                                   shuffle=False, device="cpu")
    assert len(loader) == 2
    batches = list(loader)
    assert len(batches) == 2
    direct_jax = np.asarray(
        tc.hermite_cubic_coefficients_with_backward_differences(jnp.asarray(x)))
    direct = tt.hermite_cubic_coefficients_with_backward_differences(torch.from_numpy(x))
    for i, (coeffs, labels) in enumerate(batches):
        assert isinstance(coeffs, torch.Tensor) and coeffs.device.type == "cpu"
        assert coeffs.dtype == torch.float32
        sl = slice(i * 8, (i + 1) * 8)
        assert np.allclose(coeffs.numpy(), direct_jax[sl], atol=1e-5)
        assert np.allclose(coeffs.numpy(), direct[sl].numpy(), atol=1e-5)
        assert np.array_equal(labels.numpy(), y[sl])


def test_loader_nan_cubic_and_shuffle():
    x = rng.standard_normal((16, 12, 2))
    x[rng.random(x.shape) < 0.2] = np.nan
    y = rng.random(16)
    loader = CoefficientDataLoader(x, y, batch_size=4, interpolation="cubic",
                                   shuffle=True, seed=1, device="cpu")
    seen = 0
    for coeffs, labels in loader:
        assert coeffs.shape == (4, 11, 8)
        assert torch.isfinite(coeffs).all()
        # each batch is the masked fit of its own rows
        rows = [int(np.flatnonzero(y == v)[0]) for v in labels.numpy()]
        ref = tt.natural_cubic_coeffs(torch.from_numpy(x[rows]))
        assert np.allclose(coeffs.numpy(), ref.numpy(), atol=1e-9)
        seen += 1
    assert seen == 4


def test_loader_end_to_end_training_batch():
    x, _ = _toy_data(8, channels=3)
    y = (rng.random(8) > 0.5).astype(np.float32)
    loader = CoefficientDataLoader(x, y, batch_size=8, interpolation="hermite", device="cpu")
    (coeffs, labels), = list(loader)
    X = tt.CubicSpline(coeffs)
    out = tt.cdeint(X, lambda t, z: torch.tanh(z)[..., None] * torch.ones(8, 2, 3),
                    torch.zeros(8, 2), X.interval, adjoint=False, method="rk4")
    assert torch.isfinite(out).all()


def _message(cls, *args, **kwargs):
    with pytest.raises(ValueError) as info:
        cls(*args, **kwargs)
    return str(info.value)


@pytest.mark.parametrize("case", ["samples", "interpolation", "t_shape", "logsig"])
def test_loader_validation_texts(case):
    x = rng.standard_normal((8, 10, 3))
    args = {"samples": ((x, rng.random(7), 4), {}),
            "interpolation": ((x, rng.random(8), 4), {"interpolation": "spline"}),
            "t_shape": ((x, rng.random(8), 4), {"t": np.arange(9.0)}),
            "logsig": ((x, rng.random(8), 4), {"interpolation": "logsig", "depth": 2})}
    a, kw = args[case]
    ours = _message(CoefficientDataLoader, *a, device="cpu", **kw)
    assert ours == _message(JaxLoader, *a, **kw)


def test_device_cuda_without_a_card_raises():
    x, y = _toy_data(8)
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        CoefficientDataLoader(x, y, batch_size=4)
    # Without device_put the batches stay NumPy arrays, wherever device points.
    (coeffs, labels), = list(CoefficientDataLoader(x, y, batch_size=8, device_put=False))
    assert isinstance(coeffs, np.ndarray) and isinstance(labels, np.ndarray)


def test_multi_worker_matches_single_worker_order():
    x, y = _toy_data(37)
    kw = dict(batch_size=8, interpolation="hermite", shuffle=True, seed=5, device_put=False)
    single = list(CoefficientDataLoader(x, y, num_workers=1, **kw))
    multi = list(CoefficientDataLoader(x, y, num_workers=3, **kw))
    assert len(single) == len(multi) == 4
    for (c1, l1), (c2, l2) in zip(single, multi):
        np.testing.assert_array_equal(c1, c2)
        np.testing.assert_array_equal(l1, l2)


def test_drop_last_false_yields_ragged_tail():
    x, y = _toy_data(37)
    loader = CoefficientDataLoader(x, y, batch_size=8, interpolation="linear", shuffle=False,
                                   device_put=False, drop_last=False)
    batches = list(loader)
    assert len(loader) == 5 and len(batches) == 5
    assert batches[-1][0].shape[0] == 37 - 4 * 8
    loader2 = CoefficientDataLoader(x, y, batch_size=8, interpolation="linear", shuffle=False,
                                    device_put=False)
    assert len(loader2) == 4 and len(list(loader2)) == 4


def test_multi_worker_propagates_exceptions():
    x, y = _toy_data(16)
    loader = CoefficientDataLoader(x, y, batch_size=4, interpolation="hermite", shuffle=False,
                                   device_put=False, num_workers=2)

    def fn(t, xb):
        # The third batch fails, whichever worker takes it and whenever.
        if np.array_equal(np.asarray(xb), x[8:12]):
            raise RuntimeError("boom")
        return xb

    loader._fn = fn
    got = []
    with pytest.raises(RuntimeError, match="boom"):
        for batch in loader:
            got.append(batch)
    assert len(got) == 2  # raised at the batch that failed, not after it


class _WorkerExit(BaseException):
    pass


def test_a_worker_base_exception_reaches_the_consumer():
    # An exception outside Exception (as SystemExit or KeyboardInterrupt are)
    # must still be stored for its batch: else the consumer waits forever.
    x, y = _toy_data(16)
    loader = CoefficientDataLoader(x, y, batch_size=4, interpolation="hermite", shuffle=False,
                                   device_put=False, num_workers=2)

    def fn(t, xb):
        if xb[0, 0, 0] == x[8, 0, 0]:
            raise _WorkerExit("stop")
        return xb

    loader._fn = fn
    got, raised = [], []

    def consume():
        try:
            for batch in loader:
                got.append(batch)
        except _WorkerExit as e:
            raised.append(e)

    consumer = threading.Thread(target=consume, daemon=True)
    consumer.start()
    consumer.join(timeout=30)
    assert not consumer.is_alive(), "the consumer still waits for the failed batch"
    assert [str(e) for e in raised] == ["stop"]
    assert len(got) == 2  # raised at the third batch


def test_loader_nan_batches_stay_native(monkeypatch):
    # NaN cubic and Hermite batches never reach the torch fits.
    import torchcde_tpu_torch.interpolation.cubic as cubic_mod
    import torchcde_tpu_torch.interpolation.hermite as hermite_mod

    def boom(*a, **k):
        raise AssertionError("a torch fit ran on a loader thread")

    monkeypatch.setattr(cubic_mod, "natural_cubic_coeffs", boom)
    monkeypatch.setattr(hermite_mod, "hermite_cubic_coefficients_with_backward_differences",
                        boom)
    gen = np.random.default_rng(3)
    x = gen.standard_normal((32, 20, 3)).astype(np.float32)
    x[gen.random(x.shape) < 0.3] = np.nan
    y = gen.standard_normal(32).astype(np.float32)
    for interp in ("cubic", "hermite"):
        batches = list(CoefficientDataLoader(x, y, batch_size=8, interpolation=interp,
                                             shuffle=False, device_put=False))
        assert len(batches) == 4
        for coeffs, _labels in batches:
            assert np.isfinite(coeffs).all()


def test_loader_nan_hermite_matches_jax():
    gen = np.random.default_rng(4)
    x = gen.standard_normal((8, 15, 2)).astype(np.float64)
    x[gen.random(x.shape) < 0.3] = np.nan
    y = np.zeros(8, np.float32)
    (coeffs, _), = list(CoefficientDataLoader(x, y, batch_size=8, interpolation="hermite",
                                              shuffle=False, device="cpu"))
    ref = np.asarray(tc.hermite_cubic_coefficients_with_backward_differences(jnp.asarray(x)))
    assert np.allclose(coeffs.numpy(), ref, atol=1e-9)
    port = tt.hermite_cubic_coefficients_with_backward_differences(torch.from_numpy(x))
    assert np.allclose(coeffs.numpy(), port.numpy(), atol=1e-9)


ROUTES = [("hermite", 0.0, {}), ("hermite", 0.3, {}), ("cubic", 0.0, {}), ("cubic", 0.3, {}),
          ("linear", 0.0, {}), ("linear", 0.3, {}),
          ("logsig", 0.0, dict(depth=3, window_length=4.0)),
          ("logsig", 0.3, dict(depth=2, window_length=2.5))]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("route,nan,extra", ROUTES)
def test_every_route_and_order_equal_the_jax_loaders(route, nan, extra, dtype):
    # Same seed, same permutation draw per epoch: two epochs of the port's
    # loader give the JAX loader's batches, bit for bit (both libraries are
    # built from one source with the same flags).
    gen = np.random.default_rng(7)
    x = gen.standard_normal((29, 24, 3)).astype(dtype)
    x[gen.random(x.shape) < nan] = np.nan
    y = np.arange(29, dtype=dtype)
    t = (np.arange(24) * 0.5 + 0.2 * gen.random(24)).astype(dtype)
    kw = dict(batch_size=6, interpolation=route, t=t, shuffle=True, seed=11, device_put=False,
              num_workers=3, **extra)
    ours, theirs = CoefficientDataLoader(x, y, **kw), JaxLoader(x, y, **kw)
    assert len(ours) == len(theirs) == 4
    for _epoch in range(2):
        pairs = list(zip(ours, theirs, strict=True))
        assert len(pairs) == 4
        for (c1, l1), (c2, l2) in pairs:
            np.testing.assert_array_equal(l1, np.asarray(l2))
            c2 = np.asarray(c2)
            assert c1.dtype == c2.dtype == dtype and c1.shape == c2.shape
            np.testing.assert_array_equal(c1.view(np.uint8), c2.view(np.uint8))


def test_device_put_yields_tensors_on_the_device():
    x, y = _toy_data(12)
    for coeffs, labels in CoefficientDataLoader(x, y, batch_size=4, device="cpu"):
        assert isinstance(coeffs, torch.Tensor) and isinstance(labels, torch.Tensor)
        assert coeffs.device == labels.device == torch.device("cpu")
        assert coeffs.shape == (4, 9, 8) and labels.shape == (4,)


@pytest.mark.parametrize("prefetch,workers", [(1, 1), (2, 1), (2, 3), (4, 2)])
def test_in_flight_batches_are_bounded(prefetch, workers):
    x, y = _toy_data(60)
    loader = CoefficientDataLoader(x, y, batch_size=3, interpolation="linear",
                                   device_put=False, prefetch=prefetch, num_workers=workers)
    started = []
    lock = threading.Lock()

    def fn(t, xb):
        with lock:
            started.append(1)
        return xb

    loader._fn = fn
    bound = prefetch + workers - 1
    ahead = []
    for consumed, _batch in enumerate(loader, start=1):
        time.sleep(0.01)  # a slow consumer: the workers run ahead
        with lock:
            ahead.append(len(started) - consumed)
    assert max(ahead) <= bound
    assert max(ahead) >= 1  # they did run ahead


def test_breaking_out_stops_the_workers():
    x, y = _toy_data(64)
    before = threading.active_count()
    loader = CoefficientDataLoader(x, y, batch_size=4, device_put=False, num_workers=4)
    for i, _batch in enumerate(loader):
        if i == 2:
            break
    deadline = time.monotonic() + 10
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == before


def test_many_workers_keep_order_under_stress():
    # More workers than cores, a short switch interval: every batch arrives
    # once, in order, with its own rows.
    x, y = _toy_data(240, length=6)
    y = np.arange(240, dtype=np.float32)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        loader = CoefficientDataLoader(x, y, batch_size=5, interpolation="linear",
                                       device_put=False, num_workers=16, prefetch=3, seed=2)
        order = np.random.default_rng(2).permutation(240)
        start = time.monotonic()
        batches = list(loader)
        assert time.monotonic() - start < 60
    finally:
        sys.setswitchinterval(old)
    assert len(batches) == 48
    labels = np.concatenate([b[1] for b in batches])
    np.testing.assert_array_equal(labels, order.astype(np.float32))
    for coeffs, lab in batches:
        np.testing.assert_array_equal(coeffs, x[lab.astype(np.int64)])


# --- one float64 training step, JAX against the port --------------------------

FLAGSHIP = dict(input_channels=3, hidden_channels=8, output_channels=1, width=16,
                interpolation="cubic", solver="rk4", adjoint=False, step_size=1.0)


def _spirals(batch, length, seed=0):
    gen = np.random.default_rng(seed)
    t = np.linspace(0.0, 4 * math.pi, length)
    phase = gen.uniform(0, 2 * math.pi, size=(batch, 1))
    y = (gen.random(batch) > 0.5).astype(np.float64)
    direction = np.where(y > 0.5, 1.0, -1.0)[:, None]
    radius = 0.5 + t / (4 * math.pi)
    X = np.stack([np.broadcast_to(t, (batch, length)), radius * np.cos(direction * t + phase),
                  radius * np.sin(direction * t + phase)], axis=-1)
    return X, y


def test_loader_fed_training_steps_match_jax_in_float64():
    X, y = _spirals(24, 12)
    kw = dict(batch_size=8, interpolation="hermite", shuffle=True, seed=3, num_workers=2)
    cfg = JaxConfig(**FLAGSHIP)
    params = init_neural_cde(jax.random.PRNGKey(0), cfg, dtype=jnp.float64)
    model = NeuralCDE(NeuralCDEConfig(**FLAGSHIP), device="cpu", dtype=torch.float64)
    model.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    optimizer = optax.adam(1e-3)
    opt_state = optimizer.init(params)
    jax_step = jax_make_train_step(cfg, optimizer)
    step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8))
    ours = CoefficientDataLoader(X, y, device="cpu", **kw)
    theirs = JaxLoader(X, y, device_put=False, **kw)
    losses = []
    for (coeffs, labels), (cj, lj) in zip(ours, theirs, strict=True):
        assert coeffs.dtype == torch.float64
        params, opt_state, loss_j = jax_step(params, opt_state, jnp.asarray(cj), jnp.asarray(lj))
        loss_t = step(coeffs, labels)
        losses.append((float(loss_t), float(loss_j)))
    assert len(losses) == 3
    for loss_t, loss_j in losses:
        assert math.isfinite(loss_t)
        assert abs(loss_t - loss_j) <= 1e-9, losses
