"""The port's Neural CDE training step against the JAX package, on the CPU in float64.

The flagship configuration (cubic control, rk4, step 1, direct backprop) at a
small size: JAX-initialised parameters are carried across with
``from_jax_params``, and three Adam steps on each side must track each other.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torchcde_tpu as tc
import torchcde_tpu_torch as tt
from torchcde_tpu.models.neural_cde import NeuralCDEConfig as JaxConfig
from torchcde_tpu.models.neural_cde import init_neural_cde, neural_cde_apply
from torchcde_tpu.models.training import accuracy as jax_accuracy
from torchcde_tpu.models.training import make_train_step as jax_make_train_step
from torchcde_tpu_torch.interop import from_jax_params
from torchcde_tpu_torch.models import NeuralCDE, NeuralCDEConfig, accuracy, make_train_step
from torchcde_tpu_torch.models.training import loss_fn as tt_loss_fn

torch.set_num_threads(1)

BATCH, LENGTH, WIDTH = 16, 20, 32
FLAGSHIP = dict(input_channels=3, hidden_channels=8, output_channels=1, width=WIDTH,
                interpolation="cubic", solver="rk4", adjoint=False, step_size=1.0)


def _spiral(batch, length, seed=0):
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 4 * math.pi, length)
    phase = rng.uniform(0, 2 * math.pi, size=(batch, 1))
    y = (rng.random(batch) > 0.5).astype(np.float64)
    direction = np.where(y > 0.5, 1.0, -1.0)[:, None]
    radius = 0.5 + t / (4 * math.pi)
    x1 = radius * np.cos(direction * t + phase)
    x2 = radius * np.sin(direction * t + phase)
    X = np.stack([np.broadcast_to(t, x1.shape), x1, x2], axis=-1)
    return X, y


def _jax_setup():
    cfg = JaxConfig(**FLAGSHIP)
    params = init_neural_cde(jax.random.PRNGKey(0), cfg, dtype=jnp.float64)
    return cfg, params


def _torch_model(params):
    model = NeuralCDE(NeuralCDEConfig(**FLAGSHIP), device="cpu", dtype=torch.float64)
    model.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    return model


def _coeffs(X):
    cj = tc.hermite_cubic_coefficients_with_backward_differences(jnp.asarray(X))
    ct = tt.hermite_cubic_coefficients_with_backward_differences(torch.from_numpy(X))
    return cj, ct


def test_forward_matches_neural_cde_apply():
    X, y = _spiral(BATCH, LENGTH)
    cfg, params = _jax_setup()
    model = _torch_model(params)
    cj, ct = _coeffs(X)
    expected = neural_cde_apply(params, cfg, cj)
    got = model(ct)
    assert got.shape == expected.shape == (BATCH, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(expected), rtol=1e-10, atol=1e-12)
    acc = accuracy(model, ct, torch.from_numpy(y))
    assert float(acc) == pytest.approx(float(jax_accuracy(params, cfg, cj, jnp.asarray(y))))


def test_three_adam_steps_track_optax():
    X, y = _spiral(BATCH, LENGTH, seed=1)
    cfg, params = _jax_setup()
    model = _torch_model(params)
    cj, ct = _coeffs(X)

    optimizer = optax.adam(1e-3)
    opt_state = optimizer.init(params)
    jax_step = jax_make_train_step(cfg, optimizer)
    step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8))

    for _ in range(3):
        params, opt_state, loss_j = jax_step(params, opt_state, cj, jnp.asarray(y))
        loss_t = step(ct, torch.from_numpy(y))
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-8)
    state = model.state_dict()
    for name, value in from_jax_params(jax.tree_util.tree_map(np.asarray, params)).items():
        np.testing.assert_allclose(state[name].numpy(), value.numpy(), rtol=1e-8, atol=1e-12,
                                   err_msg=name)


def test_initialisation_is_seeded_and_bounded():
    cfg = NeuralCDEConfig(**FLAGSHIP)
    a = NeuralCDE(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    b = NeuralCDE(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    bound = 1.0 / math.sqrt(WIDTH)
    assert float(a.func.linear2.weight.detach().abs().max()) <= bound
    # compute_dtype keeps the same float32 masters and computes in bfloat16:
    # the logits come back bfloat16, near the float32 model's on the same
    # quantized problem (tests/test_solver_extras.py, bfloat16 end to end).
    c = NeuralCDE(NeuralCDEConfig(**FLAGSHIP, compute_dtype="bfloat16"),
                  generator=torch.Generator().manual_seed(3), device="cpu")
    for (name, pa), pc in zip(a.named_parameters(), c.parameters()):
        assert pc.dtype == torch.float32 and torch.equal(pa, pc), name
    X, _ = _spiral(4, 8)
    coeffs = tt.hermite_cubic_coefficients_with_backward_differences(torch.from_numpy(X).float())
    with torch.no_grad():
        for param in a.parameters():
            param.copy_(param.bfloat16().float())
        out16, out32 = c(coeffs), a(coeffs.bfloat16().float())
    assert out16.dtype == torch.bfloat16 and out32.dtype == torch.float32
    np.testing.assert_allclose(out16.float().numpy(), out32.numpy(), rtol=0.06, atol=0.06)
    with pytest.raises(ValueError, match="compute_dtype"):
        NeuralCDE(NeuralCDEConfig(**FLAGSHIP, compute_dtype="int32"), device="cpu")


# The reference default: dopri5 with the adjoint.  The port routes it to K2
# (on the CPU its plain version: frozen-mesh gradients through a replay of the
# realised mesh).  The JAX package's own kernel declines off the TPU, and its
# adjoint would take the backsolve, so the JAX function with the same
# gradients is direct backprop through its XLA dense loop: adjoint=False.
#
# The paths are linear in time, not spirals: a cubic spline through a spiral
# has a jump in its second derivative at every knot, and where a step ends
# just past a knot the error estimate magnifies rounding without bound, so
# two float64 implementations' step meshes drift apart (by ~1e-2 in the
# logits here).  A linear path has no such kinks.
DEFAULT = dict(input_channels=3, hidden_channels=8, output_channels=1, width=WIDTH)


def _lines(batch, length, seed):
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, length)[None, :, None]
    X = rng.standard_normal((batch, 1, 3)) + rng.uniform(-2, 2, (batch, 1, 3)) * t
    return X, (rng.random(batch) > 0.5).astype(np.float64)


def _default_setup():
    cfg = JaxConfig(**DEFAULT, adjoint=False)
    params = init_neural_cde(jax.random.PRNGKey(0), cfg, dtype=jnp.float64)
    model = NeuralCDE(NeuralCDEConfig(**DEFAULT), device="cpu", dtype=torch.float64)
    model.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    assert (model.cfg.solver, model.cfg.adjoint) == ("dopri5", True)
    return cfg, params, model


def test_default_config_forward_matches_neural_cde_apply():
    X, _ = _lines(BATCH, LENGTH, seed=2)
    cfg, params, model = _default_setup()
    cj, ct = _coeffs(X)
    expected = neural_cde_apply(params, cfg, cj)
    got = model(ct)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(expected), rtol=1e-9,
                               atol=1e-12)


def test_default_config_three_adam_steps_track_optax():
    X, y = _lines(BATCH, LENGTH, seed=3)
    cfg, params, model = _default_setup()
    cj, ct = _coeffs(X)
    optimizer = optax.adam(1e-3)
    opt_state = optimizer.init(params)
    jax_step = jax_make_train_step(cfg, optimizer)
    step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8))
    for _ in range(3):
        params, opt_state, loss_j = jax_step(params, opt_state, cj, jnp.asarray(y))
        loss_t = step(ct, torch.from_numpy(y))
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-9)
    state = model.state_dict()
    for name, value in from_jax_params(jax.tree_util.tree_map(np.asarray, params)).items():
        np.testing.assert_allclose(state[name].numpy(), value.numpy(), rtol=1e-8, atol=1e-12,
                                   err_msg=name)


def test_default_device_is_the_card():
    # Entry points run on the card unless the caller asks for the CPU: the
    # model is built on the CUDA card by default, and without one it raises
    # rather than carrying on on the CPU.  The weights are drawn on the CPU
    # and then moved, so a seed gives the same weights on every device.
    cfg = NeuralCDEConfig(**DEFAULT)
    on_cpu = NeuralCDE(cfg, generator=torch.Generator().manual_seed(4), device="cpu")
    assert all(p.device.type == "cpu" for p in on_cpu.parameters())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            NeuralCDE(cfg, generator=torch.Generator().manual_seed(4))
        return
    on_card = NeuralCDE(cfg, generator=torch.Generator().manual_seed(4))
    for (name, a), b in zip(on_card.named_parameters(), on_cpu.parameters()):
        assert a.device.type == "cuda", name
        assert torch.equal(a.cpu(), b), name


# The NaN spiral slice: 30 % of the two value channels' entries missing (the
# time channel observed), natural cubic coefficients, then the default
# configuration.  A natural cubic spline is twice continuously
# differentiable, so the two float64 step meshes agree here.
def _nan_spiral(batch, length, seed):
    X, y = _spiral(batch, length, seed)
    rng = np.random.default_rng(seed + 100)
    X[..., 1:][rng.random(X[..., 1:].shape) < 0.3] = np.nan
    return X, y


def test_nan_spiral_default_config_matches_jax():
    X, y = _nan_spiral(8, LENGTH, seed=5)
    cfg, params, model = _default_setup()
    cj = tc.natural_cubic_coeffs(jnp.asarray(X))
    ct = tt.natural_cubic_coeffs(torch.from_numpy(X))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-12, atol=1e-12)

    def jax_loss(p):
        logits = neural_cde_apply(p, cfg, cj)[..., 0]
        return jnp.mean(jnp.clip(logits, 0) - logits * y + jnp.log1p(jnp.exp(-jnp.abs(logits))))

    np.testing.assert_allclose(model(ct).detach().numpy(),
                               np.asarray(neural_cde_apply(params, cfg, cj)),
                               rtol=1e-9, atol=1e-12)
    loss_j, grads_j = jax.value_and_grad(jax_loss)(params)
    loss_t = tt_loss_fn(model, ct, torch.from_numpy(y))
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-9)
    # Gradients: rtol 1e-8, and atol 1e-10 for entries many orders below the
    # largest (~0.3), where the two summation orders' rounding shows.
    grads = dict(model.named_parameters())
    for name, value in from_jax_params(jax.tree_util.tree_map(np.asarray, grads_j)).items():
        np.testing.assert_allclose(grads[name].grad.numpy(), value.numpy(), rtol=1e-8,
                                   atol=1e-10, err_msg=name)


# The log-ODE slice (a Neural RDE): windowed logsignatures of the series,
# linear interpolation of the transformed path, the default solve (dopri5,
# adjoint) over it.  The paths are lines with a little noise, so the
# transformed control is nearly straight and the two float64 step meshes
# agree (see above).
LOG_ODE = dict(input_channels=6, hidden_channels=8, output_channels=1, width=WIDTH,
               interpolation="linear")


def test_log_ode_linear_config_three_adam_steps_track_optax():
    rng = np.random.default_rng(0)
    t = np.linspace(0.0, 1.0, 41)[None, :, None]
    X = (rng.standard_normal((BATCH, 1, 3)) + rng.uniform(-2, 2, (BATCH, 1, 3)) * t
         + 0.01 * rng.standard_normal((BATCH, 41, 3)))
    y = (rng.random(BATCH) > 0.5).astype(np.float64)
    cj = tc.linear_interpolation_coeffs(tc.logsig_windows(jnp.asarray(X), 2, 10.0))
    ct = tt.linear_interpolation_coeffs(tt.logsig_windows(torch.from_numpy(X), 2, 10.0))
    assert ct.shape == (BATCH, 5, 6)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-10, atol=1e-12)

    cfg = JaxConfig(**LOG_ODE, adjoint=False)
    params = init_neural_cde(jax.random.PRNGKey(0), cfg, dtype=jnp.float64)
    model = NeuralCDE(NeuralCDEConfig(**LOG_ODE), device="cpu", dtype=torch.float64)
    model.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    assert (model.cfg.solver, model.cfg.adjoint) == ("dopri5", True)
    np.testing.assert_allclose(model(ct).detach().numpy(),
                               np.asarray(neural_cde_apply(params, cfg, cj)), rtol=1e-9,
                               atol=1e-12)
    optimizer = optax.adam(1e-3)
    opt_state = optimizer.init(params)
    jax_step = jax_make_train_step(cfg, optimizer)
    step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8))
    for _ in range(3):
        params, opt_state, loss_j = jax_step(params, opt_state, cj, jnp.asarray(y))
        loss_t = step(ct, torch.from_numpy(y))
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-9)
    state = model.state_dict()
    for name, value in from_jax_params(jax.tree_util.tree_map(np.asarray, params)).items():
        np.testing.assert_allclose(state[name].numpy(), value.numpy(), rtol=1e-8, atol=1e-12,
                                   err_msg=name)


# BASELINE config 5: reversible Heun at step 1.0, with direct backpropagation
# and with the exact inverse-map adjoint.  On the CPU the port's MLP field
# takes K8's plain version, which evaluates dX/dt at a knot with the next
# interval's rows; the JAX package's XLA path (its kernel declines off the
# TPU) reads the left interval there.  A Hermite spline is C1, so the two
# agree up to rounding, and the weights' gradients with them.
CONFIG5 = dict(input_channels=3, hidden_channels=8, output_channels=1, width=WIDTH,
               interpolation="cubic", solver="reversible_heun", step_size=1.0)


@pytest.mark.parametrize("adjoint", [False, True])
def test_reversible_heun_config_three_adam_steps_track_optax(adjoint):
    X, y = _spiral(BATCH, LENGTH, seed=6)
    cfg = JaxConfig(**CONFIG5, adjoint=adjoint)
    params = init_neural_cde(jax.random.PRNGKey(0), cfg, dtype=jnp.float64)
    model = NeuralCDE(NeuralCDEConfig(**CONFIG5, adjoint=adjoint), device="cpu",
                      dtype=torch.float64)
    model.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    cj, ct = _coeffs(X)
    np.testing.assert_allclose(model(ct).detach().numpy(),
                               np.asarray(neural_cde_apply(params, cfg, cj)), rtol=1e-10,
                               atol=1e-12)
    optimizer = optax.adam(1e-3)
    opt_state = optimizer.init(params)
    jax_step = jax_make_train_step(cfg, optimizer)
    step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8))
    for _ in range(3):
        params, opt_state, loss_j = jax_step(params, opt_state, cj, jnp.asarray(y))
        loss_t = step(ct, torch.from_numpy(y))
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-9)
    state = model.state_dict()
    for name, value in from_jax_params(jax.tree_util.tree_map(np.asarray, params)).items():
        np.testing.assert_allclose(state[name].numpy(), value.numpy(), rtol=1e-8, atol=1e-12,
                                   err_msg=name)
