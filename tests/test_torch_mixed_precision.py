"""Mixed precision (``compute_dtype="bfloat16"``) in the port against the JAX package.

On the CPU the port's bfloat16 fixed-step solve runs the plain version of
K1's bfloat16 mode: the slab table stays bfloat16, the state and every sum
float32, and the stage products' operands are rounded to bfloat16 where the
JAX kernel feeds its matrix unit.  It is held against the JAX K1 kernel in
Pallas interpret mode on the same bfloat16 inputs.  Both sides sum in
float32 in their own orders, so an operand may round to the neighbouring
bfloat16 value now and then; the criterion is that the port's distance from
the JAX kernel is at most a tenth of the JAX kernel's own bfloat16-versus-
float32 gap, in relative Frobenius norm, for the solution and every
gradient.  A port that rounded anywhere else, or not at all, lands at about
that gap.  The CUDA kernels are held against the plain version on the card
by ``chip_smoke.py``.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torchcde_tpu as tc
import torchcde_tpu_torch as tt
from torchcde_tpu.models.neural_cde import NeuralCDEConfig as JaxConfig
from torchcde_tpu.models.neural_cde import init_neural_cde
from torchcde_tpu.models.training import make_loss_fn
from torchcde_tpu.solvers import fused_pallas
from torchcde_tpu.solvers.terms import MLPVectorField as JaxField
from torchcde_tpu_torch.interop import from_jax_params
from torchcde_tpu_torch.models import NeuralCDE, NeuralCDEConfig, make_train_step
from torchcde_tpu_torch.models import neural_cde
from torchcde_tpu_torch.models.neural_cde import _field_as
from torchcde_tpu_torch.models.training import loss_fn
from torchcde_tpu_torch.solvers import fused_fixed_kernel as k1
from torchcde_tpu_torch.solvers.adjoint import closure_params
from torchcde_tpu_torch.solvers.terms import MLPVectorField

torch.set_num_threads(1)

BF = torch.bfloat16
SHARE = 0.1  # the port's gap to JAX, as a share of JAX's bf16-vs-f32 gap
NAMES = ("coeffs", "z0", "w1", "b1", "w2", "b2")


@pytest.fixture
def forced_interpret():
    fused_pallas.force_fused_pallas(True)
    yield
    fused_pallas.force_fused_pallas(None)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _assert_within_share(name, port, jax16, jax32):
    gap = _rel(jax16, jax32)
    assert _rel(port, jax16) <= SHARE * gap, (name, _rel(port, jax16), gap)


def _k1_problem(H, C=3, W=16, L=6, B=4, seed=0):
    """float32 arrays: Hermite coefficients (computed once, in JAX) and the
    field's weights at the model's scales."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, C)).astype(np.float32)
    coeffs = np.asarray(tc.hermite_cubic_coefficients_with_backward_differences(jnp.asarray(x)))
    return dict(coeffs=coeffs, z0=rng.standard_normal((B, H)).astype(np.float32),
                w1=(rng.standard_normal((H, W)) * 0.4).astype(np.float32),
                b1=(rng.standard_normal(W) * 0.2).astype(np.float32),
                w2=(rng.standard_normal((W, H * C)) * 0.3).astype(np.float32),
                b2=(rng.standard_normal(H * C) * 0.2).astype(np.float32))


def _jax_k1(p, H, method, m, dtype):
    """Solution and gradients of sum(sin(out)) through the JAX K1 kernel
    (interpret mode) on the arrays rounded to bfloat16, computed in dtype."""
    C = p["coeffs"].shape[-1] // 4

    def loss(coeffs, z0, w1, b1, w2, b2):
        X = tc.CubicSpline(coeffs)
        out = tc.cdeint(X, JaxField(w1, b1, w2, b2, H, C), z0, X.interval, adjoint=False,
                        method=method, options=dict(step_size=1.0 / m))
        return jnp.sum(jnp.sin(out.astype(jnp.float32))), out

    args = [jnp.asarray(p[k]).astype(jnp.bfloat16).astype(dtype) for k in NAMES]
    (_, out), grads = jax.value_and_grad(loss, argnums=tuple(range(6)), has_aux=True)(*args)
    return out, grads


def _port_k1(p, H, method, m):
    """The same through the port's cdeint on bfloat16 tensors."""
    C = p["coeffs"].shape[-1] // 4
    leaves = [torch.from_numpy(p[k]).to(BF).requires_grad_() for k in NAMES]
    coeffs, z0, w1, b1, w2, b2 = leaves
    field = MLPVectorField(H, C, w1.shape[1], dtype=BF)
    for layer, weight, bias in ((field.linear1, w1.t(), b1), (field.linear2, w2.t(), b2)):
        del layer.weight, layer.bias
        layer.weight, layer.bias = weight, bias
    X = tt.CubicSpline(coeffs)
    k1.reset_launch_counts()
    out = tt.cdeint(X, field, z0, X.interval, adjoint=False, method=method,
                    options=dict(step_size=1.0 / m))
    torch.sin(out.float()).sum().backward()
    return out, [t.grad for t in leaves]


@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("method", ["rk4", "euler"])
@pytest.mark.parametrize("H, C", [(4, 3), (8, 3), (16, 3), (8, 5)], ids=["4", "8", "H16", "C5"])
def test_plain_k1_bf16_matches_jax_kernel(H, C, method, m, forced_interpret):
    # H 4 runs the JAX kernel's padded layout (H % 8 != 0), whose selection
    # products round too; H 8 and 16 its matrix-free path (the CUDA kernels
    # take H 16 as two state slices), and C 5 with five channels.
    p = _k1_problem(H, C=C)
    out16, grads16 = _jax_k1(p, H, method, m, jnp.bfloat16)
    out32, grads32 = _jax_k1(p, H, method, m, jnp.float32)
    out, grads = _port_k1(p, H, method, m)
    assert out16.dtype == jnp.bfloat16 and out.dtype == BF
    assert out.shape == out16.shape == (4, 2, H)
    _assert_within_share("solution", out.detach().float(), out16.astype(jnp.float32), out32)
    for name, g, g16, g32 in zip(NAMES, grads, grads16, grads32):
        assert g16.dtype == jnp.bfloat16 and g.dtype == BF, name
        _assert_within_share(name, g.float(), g16.astype(jnp.float32), g32)


def test_bf16_packing_keeps_slabs_and_upcasts_the_rest():
    p = _k1_problem(8)
    X = tt.CubicSpline(torch.from_numpy(p["coeffs"]).to(BF))
    field = MLPVectorField(8, 3, 16, dtype=BF)
    z0 = torch.from_numpy(p["z0"]).to(BF)
    native = k1.pack_operands(X._b, X._two_c, X._three_d, z0, field, ct_store="native")
    assert native.ct.dtype == BF and native.out_dtype == BF
    assert all(t.dtype == torch.float32 for t in (native.z0t, native.w1t, native.b1, native.w2t,
                                                   native.b2))
    upcast = k1.pack_operands(X._b, X._two_c, X._three_d, z0, field)  # K8's packing
    assert upcast.ct.dtype == torch.float32 and upcast.out_dtype == BF
    assert torch.equal(upcast.ct, native.ct.float())
    # Mixed dtypes decline, as in the JAX package.
    assert k1.pack_operands(X._b, X._two_c, X._three_d, z0.float(), field) is None
    assert k1.try_fused_mlp((X._b, X._two_c, X._three_d), z0, field.float(), "rk4", 1, 1.0,
                            5) is None


def test_mx_flag_rounds_on_both_layouts():
    # On the same bfloat16-valued operands, a bfloat16 slab table (the
    # bfloat16 mode) moves the solution from that of the upcast table by
    # bfloat16 rounding: more than float32 noise, far less than the solution,
    # for the matrix-free (H 8) and padded (H 4) layouts alike (where it
    # rounds is held against the JAX kernel above).
    for H in (4, 8):
        rng = np.random.default_rng(H)
        n, C, B, W = 3, 3, 5, 16
        ops = [torch.from_numpy(a).float() for a in (
            rng.standard_normal((n, 3, C, B)), rng.standard_normal((H, B)),
            rng.standard_normal((W, H)) * 0.3, rng.standard_normal(W) * 0.1,
            rng.standard_normal((C * H, W)) * 0.3, rng.standard_normal(C * H) * 0.1)]
        ops = [t.to(BF) if i == 0 else t.to(BF).float() for i, t in enumerate(ops)]
        plain = k1.fused_fixed_solve_reference(ops[0].float(), *ops[1:], "rk4", 1, 1.0, (n,))
        mx = k1.fused_fixed_solve_reference(*ops, "rk4", 1, 1.0, (n,))
        assert plain.dtype == mx.dtype == torch.float32
        assert 1e-5 < _rel(mx, plain) < 1e-1


# The slice: bench.py's configuration (rk4, step 1, no adjoint), small.
FLAGSHIP = dict(input_channels=3, hidden_channels=8, output_channels=1, width=16,
                interpolation="cubic", solver="rk4", adjoint=False, step_size=1.0)


def _spiral(batch, length, seed):
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 4 * np.pi, length)
    phase = rng.uniform(0, 2 * np.pi, size=(batch, 1))
    y = (rng.random(batch) > 0.5).astype(np.float32)
    direction = np.where(y > 0.5, 1.0, -1.0)[:, None]
    radius = 0.5 + t / (4 * np.pi)
    X = np.stack([np.broadcast_to(t, phase.shape[:1] + t.shape), radius * np.cos(direction * t + phase),
                  radius * np.sin(direction * t + phase)], axis=-1).astype(np.float32)
    return X, y


def _lines(batch, length, seed):
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, length)[None, :, None]
    X = rng.standard_normal((batch, 1, 3)) + rng.uniform(-2, 2, (batch, 1, 3)) * t
    return X.astype(np.float32), (rng.random(batch) > 0.5).astype(np.float32)


def _jax_slice(cfg_kwargs, X, y, compute_dtype):
    """Logits, master gradients and the logits after one Adam step, through
    neural_cde_apply with the JAX kernels in interpret mode."""
    cfg = JaxConfig(**cfg_kwargs, compute_dtype=compute_dtype)
    params = init_neural_cde(jax.random.PRNGKey(0), cfg)
    coeffs = tc.hermite_cubic_coefficients_with_backward_differences(jnp.asarray(X))
    loss = make_loss_fn(cfg)
    from torchcde_tpu.models.neural_cde import neural_cde_apply

    logits = neural_cde_apply(params, cfg, coeffs)
    grads = jax.grad(loss)(params, coeffs, jnp.asarray(y))
    optimizer = optax.adam(1e-3)
    updates, _ = optimizer.update(grads, optimizer.init(params), params)
    stepped = neural_cde_apply(optax.apply_updates(params, updates), cfg, coeffs)
    return params, coeffs, logits, grads, stepped


def _port_slice(cfg_kwargs, params, X, y):
    """Logits, master gradients, the cotangents of the initial and readout
    layers' outputs, and the logits after one Adam step, through the port."""
    model = NeuralCDE(NeuralCDEConfig(**cfg_kwargs, compute_dtype="bfloat16"), device="cpu")
    model.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    coeffs = tt.hermite_cubic_coefficients_with_backward_differences(torch.from_numpy(X))
    with torch.no_grad():
        logits = model(coeffs)
    cotangents = {}
    layers = {(model.initial.in_features, model.initial.out_features): "initial.bias",
              (model.readout.in_features, model.readout.out_features): "readout.bias"}
    dense_forward = neural_cde._Dense.forward

    def recording_forward(self, x):
        out = dense_forward(self, x)
        name = layers.get((self.in_features, self.out_features))
        if name is not None and out.requires_grad:
            out.register_hook(lambda g: cotangents.__setitem__(name, g))
        return out

    with mock.patch.object(neural_cde._Dense, "forward", recording_forward):
        loss_fn(model, coeffs, torch.from_numpy(y)).backward()
    grads = {name: p.grad.clone() for name, p in model.named_parameters()}
    assert all(p.dtype == torch.float32 for p in model.parameters())
    step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8))
    step(coeffs, torch.from_numpy(y))
    with torch.no_grad():
        stepped = model(coeffs)
    return logits, grads, cotangents, stepped, model


def _check_slice(cfg_kwargs, X, y):
    params, _, logits16, grads16, stepped16 = _jax_slice(cfg_kwargs, X, y, "bfloat16")
    _, _, logits32, grads32, stepped32 = _jax_slice(cfg_kwargs, X, y, None)
    logits, grads, cotangents, stepped, model = _port_slice(cfg_kwargs, params, X, y)
    assert logits.dtype == BF and logits16.dtype == jnp.bfloat16
    _assert_within_share("logits", logits.float(), logits16.astype(jnp.float32), logits32)
    expected16 = from_jax_params(jax.tree_util.tree_map(np.asarray, grads16))
    expected32 = from_jax_params(jax.tree_util.tree_map(np.asarray, grads32))
    for name, g in grads.items():
        assert g.dtype == expected16[name].dtype == torch.float32, name
        if name in cotangents:
            # A dense layer's bias gradient sums the batch's bfloat16
            # cotangents: PyTorch in float32, rounded once; XLA on the CPU
            # rounds to bfloat16 after every addition.  So the port's is the
            # float32 sum of its cotangents, and the same cotangents summed
            # the XLA way hold the criterion against JAX's.
            ct = cotangents[name]
            assert torch.equal(g, ct.float().sum(0).bfloat16().float()), name
            seq = torch.zeros(ct.shape[1:], dtype=BF)
            for row in ct:
                seq = seq + row
            _assert_within_share(name, seq.float(), expected16[name], expected32[name])
            continue
        _assert_within_share(name, g, expected16[name], expected32[name])
    _assert_within_share("logits after one Adam step", stepped.float(),
                         stepped16.astype(jnp.float32), stepped32)
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_bf16_flagship_slice_matches_neural_cde_apply(forced_interpret):
    # At the K1 test's small sizes: the more roundings a solve makes, the
    # likelier one of them falls on the other side of a bfloat16 boundary in
    # the two float32 summation orders (chip_smoke.py holds the kernels at
    # full size with a criterion that counts such flips).
    X, y = _spiral(8, 6, seed=1)
    k1.reset_launch_counts()
    _check_slice(FLAGSHIP, X, y)


def test_bf16_default_config_matches_neural_cde_apply(forced_interpret):
    # dopri5 with the adjoint through K2 (both packages route it to their
    # fused kernel, which upcasts bfloat16 at its boundary), on paths linear
    # in time (see tests/test_torch_model.py: rough controls part the meshes).
    X, y = _lines(8, 6, seed=2)
    _check_slice(dict(input_channels=3, hidden_channels=8, output_channels=1, width=16), X, y)


def test_bf16_adjoint_off_the_kernels_reaches_the_masters():
    # Off the fused kernels (knots not uniform) the backsolve adjoint takes
    # the bfloat16 view's cast tensors as the field's tensors, and the
    # float32 masters receive their gradients through the casts: they match
    # the float32 adjoint's on the same bfloat16-rounded problem to bfloat16
    # accuracy (the backsolve carries its adjoint state in bfloat16 over 50
    # steps; measured 1e-3..6e-2 relative; a missing path gives ~1).
    X_np, _ = _lines(4, 6, seed=3)
    t = torch.tensor([0.0, 0.7, 2.0, 2.5, 4.0, 5.0])
    coeffs = tt.hermite_cubic_coefficients_with_backward_differences(torch.from_numpy(X_np), t)
    grads = {}
    for compute_dtype in ("bfloat16", None):
        cfg = NeuralCDEConfig(3, 4, 1, width=16, solver="rk4", step_size=0.1,
                              compute_dtype=compute_dtype)
        model = NeuralCDE(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        c = coeffs
        if compute_dtype is None:
            with torch.no_grad():
                for param in model.parameters():
                    param.copy_(param.bfloat16().float())
            c = coeffs.bfloat16().float()
        else:
            field = _field_as(model.func, BF)
            X = tt.CubicSpline(coeffs.to(BF), t)
            views = [field.linear1.weight, field.linear1.bias, field.linear2.weight,
                     field.linear2.bias]
            found = closure_params(field, X, t[0], torch.zeros(4, 4, dtype=BF)).params
            assert all(any(p is v for p in found) for v in views)
        model(c, t).float().square().sum().backward()
        grads[compute_dtype] = [p.grad for p in model.parameters()]
    for g16, g32 in zip(grads["bfloat16"], grads[None]):
        assert g16.dtype == torch.float32 and g16.abs().sum() > 0
        assert _rel(g16, g32) < 0.1


def test_kernel_route_takes_the_bf16_mode(monkeypatch):
    # The autograd Function around the launches, with plain stand-ins for
    # them: a bfloat16 slab table passes to the launches as it is (the mode
    # the CUDA wrapper derives from its dtype), its cotangent comes back
    # bfloat16, and values and gradients are the CPU route's.
    seen = []

    def forward(ct, z0t, w1t, b1, w2t, b2, plan):
        seen.append(ct.dtype)
        n = ct.shape[0]
        with torch.no_grad():
            out = k1.fused_fixed_solve_reference(ct, z0t, w1t, b1, w2t, b2, plan.method, plan.m,
                                                 plan.dt_sub, plan.out_knots)
            zres = k1.fused_fixed_solve_reference(ct, z0t, w1t, b1, w2t, b2, plan.method,
                                                  plan.m, plan.dt_sub, tuple(range(1, n + 1)))
        return out, zres

    def backward(ct, zres, z0t, gz, w1t, b1, w2t, b2, plan):
        seen.append(ct.dtype)
        leaves = [t.detach().requires_grad_() for t in (ct, z0t, w1t, b1, w2t, b2)]
        with torch.enable_grad():
            out = k1.fused_fixed_solve_reference(*leaves, plan.method, plan.m, plan.dt_sub,
                                                 plan.out_knots)
            return torch.autograd.grad(out, leaves, gz)

    monkeypatch.setattr(k1, "launch_forward", forward)
    monkeypatch.setattr(k1, "launch_backward", backward)
    rng = np.random.default_rng(6)
    n, C, B, H, W = 4, 3, 5, 8, 16
    ops = [torch.from_numpy(a).float() for a in (
        rng.standard_normal((n, 3, C, B)) * 0.3, rng.standard_normal((H, B)),
        rng.standard_normal((W, H)) * 0.3, rng.standard_normal(W) * 0.1,
        rng.standard_normal((C * H, W)) * 0.3, rng.standard_normal(C * H) * 0.1)]
    ops = [ops[0].to(BF)] + [t.to(BF).float() for t in ops[1:]]
    results = []
    for route in ("kernel", "plain"):
        leaves = [t.clone().requires_grad_() for t in ops]
        if route == "kernel":
            out = k1._FusedFixedSolve.apply(*leaves, k1._Plan("rk4", 2, 0.5, (2, n)))
        else:
            out = k1.fused_fixed_solve(*leaves, "rk4", 2, 0.5, (2, n))
        out.square().sum().backward()
        results.append([out.detach()] + [t.grad for t in leaves])
    assert seen == [BF, BF]
    assert results[0][1].dtype == BF
    for got, expected in zip(*results):
        assert got.dtype == expected.dtype
        torch.testing.assert_close(got, expected, rtol=0, atol=0)
    # The wrapper takes float32 and bfloat16 slab tables only, on the card.
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        k1._slab_mode(ops[0].double())
    with pytest.raises(ValueError, match="must lie on"):
        k1.check_operands(ops, ("ct", "z0t", "w1t", "b1", "w2t", "b2"), dtypes={"ct": BF})
