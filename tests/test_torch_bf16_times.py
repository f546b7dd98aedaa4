"""bfloat16 time tensors in the port, against the JAX package on the CPU.

Every entry point that plans on the host reads the output times (and a
control's knot times) into NumPy.  NumPy has no bfloat16, so the port upcasts
a bfloat16 tensor to float32 first; the solve itself stays in the state's
dtype, and so does its output.

Criteria.  A bfloat16 solve is 1-5 % from the float32 one, and the port
and JAX round at other places (XLA fuses bfloat16 elementwise chains and
computes them in float32; PyTorch rounds after every operation), so the two
bfloat16 solves are about as far from each other as each is from the float32
solve (measured: 0.7-4.8 % apart, against JAX's own 0.6-5.4 % gap).  So:

* against JAX's float32 solve, the port's bfloat16 solution is within 0.1 of
  the largest magnitude, the bound of ``tests/test_solver_extras.py``'s
  bfloat16 test;
* where JAX's own bfloat16 solve runs (every case but dopri5, whose bfloat16
  host times stall JAX's controller into NaN or a wrong answer; the port
  plans in float32), the port's relative error against JAX's float32 solve is
  at most twice JAX's own;
* cubic controls, on which JAX's solve with a bfloat16 ``t`` fails on its own
  carry dtype, are held against the port's float32 solve within 0.1 of the
  largest magnitude.

z0 is nonzero: with z0 = 0 and a field tanh(z W) the solution stays 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchcde_tpu as tc
import torchcde_tpu_torch as tt
from torchcde_tpu.solvers.terms import MLPVectorField as JaxField
from torchcde_tpu_torch.solvers.terms import MLPVectorField

torch.set_num_threads(1)

B, L, C, H, W = 4, 7, 3, 4, 16
BOUND = 0.1  # largest error over largest magnitude
ACCURACY = 2.0  # the port's bf16 error as a multiple of JAX's own


def _problem(seed=0):
    r = np.random.default_rng(seed)
    return dict(x=r.standard_normal((B, L, C)).astype(np.float32),
                t=np.linspace(0.0, 3.0, L).astype(np.float32),
                z0=r.standard_normal((B, H)).astype(np.float32),
                w1=(r.standard_normal((H, W)) * 0.4).astype(np.float32),
                b1=(r.standard_normal(W) * 0.2).astype(np.float32),
                w2=(r.standard_normal((W, H * C)) * 0.3).astype(np.float32),
                b2=(r.standard_normal(H * C) * 0.2).astype(np.float32),
                ts=np.stack([np.linspace(0.0, 3.0 - 0.5 * i, 3) for i in range(B)]
                            ).astype(np.float32))


def _options(method, per_sample):
    options = {} if method == "dopri5" else {"step_size": 0.5}
    if per_sample:
        options["per_sample"] = True
    return options


def _jax_solve(p, dtype, method, adjoint, control, per_sample=False):
    t = jnp.asarray(p["t"], dtype)
    x = jnp.asarray(p["x"], dtype)
    if control == "linear":
        X = tc.LinearInterpolation(tc.linear_interpolation_coeffs(x, t=t), t=t)
    else:
        X = tc.CubicSpline(tc.hermite_cubic_coefficients_with_backward_differences(x))
        t = jnp.arange(L, dtype=dtype)
    field = JaxField(*(jnp.asarray(p[k], dtype) for k in ("w1", "b1", "w2", "b2")), H, C)
    ts = jnp.asarray(p["ts"], dtype) if per_sample else t
    out = tc.cdeint(X, field, jnp.asarray(p["z0"], dtype), ts, adjoint=adjoint, method=method,
                    options=_options(method, per_sample))
    return np.asarray(out.astype(jnp.float32), np.float64)


def _port_solve(p, dtype, method, adjoint, control, per_sample=False):
    """The solution (float64 copy), its dtype, and the gradient of a loss
    with respect to z0.  A linear control takes the times as its knots; a
    cubic one the default grid 0..L-1, whose knots are the output times
    (per-sample: the batched times), so the fused routes plan the solve."""
    t = torch.tensor(p["t"]).to(dtype)
    x = torch.tensor(p["x"]).to(dtype)
    if control == "linear":
        X = tt.LinearInterpolation(tt.linear_interpolation_coeffs(x, t=t), t=t)
    else:
        X = tt.CubicSpline(tt.hermite_cubic_coefficients_with_backward_differences(x))
        t = torch.arange(L).to(dtype)
    field = MLPVectorField(H, C, W)
    with torch.no_grad():
        field.linear1.weight.copy_(torch.tensor(p["w1"].T))
        field.linear1.bias.copy_(torch.tensor(p["b1"]))
        field.linear2.weight.copy_(torch.tensor(p["w2"].T))
        field.linear2.bias.copy_(torch.tensor(p["b2"]))
    field = field.to(dtype)
    z0 = torch.tensor(p["z0"]).to(dtype).requires_grad_()
    ts = torch.tensor(p["ts"]).to(dtype) if per_sample else t
    out = tt.cdeint(X, field, z0, ts, adjoint=adjoint, method=method,
                    options=_options(method, per_sample))
    (grad,) = torch.autograd.grad(out.float().square().sum(), z0)
    return out.detach().double().numpy(), out.dtype, grad


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _largest_err(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def _check_bf16(port, dtype, grad, ref32, jax16):
    assert dtype == torch.bfloat16 and grad.dtype == torch.bfloat16
    assert np.isfinite(port).all() and torch.isfinite(grad).all()
    assert port.shape == ref32.shape
    assert _largest_err(port, ref32) < BOUND, _largest_err(port, ref32)
    if jax16 is not None:
        assert _rel(port, ref32) <= ACCURACY * _rel(jax16, ref32), (
            _rel(port, ref32), _rel(jax16, ref32))


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("method", ["euler", "rk4", "dopri5", "reversible_heun"])
def test_linear_control_with_bfloat16_times_matches_jax(method, adjoint):
    p = _problem()
    ref32 = _jax_solve(p, jnp.float32, method, adjoint, "linear")
    jax16 = (None if method == "dopri5"
             else _jax_solve(p, jnp.bfloat16, method, adjoint, "linear"))
    _check_bf16(*_port_solve(p, torch.bfloat16, method, adjoint, "linear"), ref32, jax16)


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("times", ["batched", "shared"])
def test_per_sample_with_bfloat16_times_matches_jax(times, adjoint):
    # The fused per-sample route: each lane's initial step is proposed with
    # a probe of the bfloat16 field (batched (B, 3) times, or 1-D times).
    p = _problem(seed=1)
    if times == "shared":
        p["ts"] = p["ts"][0]
    ref32 = _jax_solve(p, jnp.float32, "dopri5", adjoint, "cubic", per_sample=True)
    jax16 = _jax_solve(p, jnp.bfloat16, "dopri5", adjoint, "cubic", per_sample=True)
    port, dtype, grad = _port_solve(p, torch.bfloat16, "dopri5", adjoint, "cubic",
                                    per_sample=True)
    _check_bf16(port, dtype, grad, ref32, jax16)


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("method", ["rk4", "dopri5", "reversible_heun"])
def test_cubic_control_with_bfloat16_times_matches_the_float32_solve(method, adjoint):
    # Knot-aligned bfloat16 output times on uniform knots and an
    # MLPVectorField: the fused routes plan the solve on the host.
    p = _problem(seed=2)
    ref32 = _port_solve(p, torch.float32, method, adjoint, "cubic")[0]
    _check_bf16(*_port_solve(p, torch.bfloat16, method, adjoint, "cubic"), ref32, None)


def test_logsig_windows_with_bfloat16_times_matches_jax():
    r = np.random.default_rng(3)
    x = r.standard_normal((2, 9, 2)).astype(np.float32)
    t = np.linspace(0.0, 4.0, 9).astype(np.float32)
    ref = np.asarray(tc.logsig_windows(jnp.asarray(x), 2, 1.0, t=jnp.asarray(t)), np.float64)
    got = tt.logsig_windows(torch.tensor(x).to(torch.bfloat16), 2, 1.0,
                            t=torch.tensor(t).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    assert _largest_err(got.double().numpy(), ref) < BOUND
