"""The port's fused fixed-step solve (kernel K1's module) against the JAX package.

On the CPU the port's ``cdeint`` runs the plain PyTorch version of the K1
kernels on the packed operands, and the JAX package runs its streamed XLA
scan (its Pallas kernel declines off the TPU): the two are held together in
values and in gradients with respect to z0, both Linear layers and the
coefficient tensor.  The CUDA kernels themselves are held against the plain
version on the card by ``chip_smoke.py``.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchcde_tpu as tc
import torchcde_tpu_torch as tt
from torchcde_tpu.solvers.fused_pallas import _pack_operands
from torchcde_tpu.solvers.terms import MLPVectorField as JaxField
from torchcde_tpu_torch.solvers import fused_fixed_kernel as k1
from torchcde_tpu_torch.solvers.terms import MLPVectorField

torch.set_num_threads(1)

C, W, B, N = 3, 32, 37, 12  # N intervals, N + 1 knots


def _problem(H, dtype, seed=0, C_=C, W_=W):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N + 1, C_))
    coeffs = np.array(tc.hermite_cubic_coefficients_with_backward_differences(jnp.asarray(x)))
    params = dict(
        # The scales of the model's U(-1/sqrt(fan_in), 1/sqrt(fan_in)) init.
        w1=rng.standard_normal((H, W_)) * 0.2, b1=rng.standard_normal(W_) * 0.1,
        w2=rng.standard_normal((W_, H * C_)) * 0.1, b2=rng.standard_normal(H * C_) * 0.1,
        z0=rng.standard_normal((B, H)),
    )
    params = {k: v.astype(dtype) for k, v in params.items()}
    return coeffs.astype(dtype), params


def _times(which):
    grid = np.linspace(0.0, float(N), N + 1)
    return {"all": grid, "terminal": grid[[0, -1]], "subset": grid[[2, 5, 6, 9]]}[which]


def _jax_solve(coeffs, p, H, t, method, step):
    C_ = coeffs.shape[-1] // 4

    def run(c, z0, w1, b1, w2, b2):
        X = tc.CubicSpline(c)
        return tc.cdeint(X, JaxField(w1, b1, w2, b2, H, C_), z0, t, adjoint=False,
                         method=method, options=dict(step_size=step))

    args = tuple(jnp.asarray(a) for a in (coeffs, p["z0"], p["w1"], p["b1"], p["w2"], p["b2"]))
    out = run(*args)
    proj = np.random.default_rng(9).standard_normal(out.shape).astype(out.dtype)
    grads = jax.grad(lambda *a: jnp.sum(run(*a) * proj), argnums=tuple(range(6)))(*args)
    return np.asarray(out), proj, [np.asarray(g) for g in grads]


def _torch_solve(coeffs, p, H, t, method, step, proj):
    dtype = torch.from_numpy(coeffs).dtype
    field = MLPVectorField(H, coeffs.shape[-1] // 4, p["w1"].shape[1], dtype=dtype)
    with torch.no_grad():
        field.linear1.weight.copy_(torch.from_numpy(p["w1"].T))
        field.linear1.bias.copy_(torch.from_numpy(p["b1"]))
        field.linear2.weight.copy_(torch.from_numpy(p["w2"].T))
        field.linear2.bias.copy_(torch.from_numpy(p["b2"]))
    c = torch.from_numpy(coeffs).requires_grad_()
    z0 = torch.from_numpy(p["z0"]).requires_grad_()
    out = tt.cdeint(tt.CubicSpline(c), field, z0, t, adjoint=False, method=method,
                    options=dict(step_size=step))
    (out * torch.from_numpy(proj)).sum().backward()
    grads = [c.grad, z0.grad, field.linear1.weight.grad.T, field.linear1.bias.grad,
             field.linear2.weight.grad.T, field.linear2.bias.grad]
    return out.detach().numpy(), [g.numpy() for g in grads]


def _compare(coeffs, p, H, which, method, m, rtol, atol):
    t = _times(which)
    out_j, proj, grads_j = _jax_solve(coeffs, p, H, t, method, 1.0 / m)
    out_t, grads_t = _torch_solve(coeffs, p, H, t, method, 1.0 / m, proj)
    assert out_t.shape == out_j.shape == (B, len(t), H)
    # atol is relative to the array's largest magnitude: a gradient entry is a
    # sum over the batch and the steps, and one that cancels to near zero
    # keeps the rounding of its largest terms.
    pairs = zip(["solution", "coeffs", "z0", "w1", "b1", "w2", "b2"],
                [out_t] + grads_t, [out_j] + grads_j)
    for name, got, expected in pairs:
        scale = max(1.0, float(np.abs(expected).max()))
        np.testing.assert_allclose(got, expected, rtol=rtol, atol=atol * scale, err_msg=name)


# float64: both sides evaluate the same arithmetic in another order.
@pytest.mark.parametrize("which", ["all", "terminal", "subset"])
@pytest.mark.parametrize("H", [8, 5])
@pytest.mark.parametrize("m", [1, 2])
@pytest.mark.parametrize("method", ["euler", "midpoint", "heun", "rk4"])
def test_cdeint_matches_jax_float64(method, m, H, which):
    coeffs, p = _problem(H, np.float64)
    _compare(coeffs, p, H, which, method, m, rtol=1e-9, atol=1e-11)


# Other shapes inside the JAX kernel's caps (C * H <= 512, 3 * C <= 16,
# width <= 512), which the CUDA kernels run on the card split over state
# slices (H 16 and 100; H 7 padded to one slice of 8).
@pytest.mark.parametrize("H, C_, W_", [(7, 2, 64), (16, 5, 512), (100, 5, 16)])
def test_cdeint_matches_jax_inside_the_caps(H, C_, W_):
    coeffs, p = _problem(H, np.float64, C_=C_, W_=W_)
    _compare(coeffs, p, H, "subset", "midpoint", 2, rtol=1e-9, atol=1e-11)


def test_cdeint_matches_jax_float32():
    # float32: the two sides round 12 intervals of rk4 in different orders.
    coeffs, p = _problem(8, np.float32)
    _compare(coeffs, p, 8, "terminal", "rk4", 1, rtol=1e-5, atol=1e-6)


def test_cpu_path_runs_the_plain_version():
    coeffs, p = _problem(8, np.float64)
    k1.reset_launch_counts()
    _torch_solve(coeffs, p, 8, _times("terminal"), "rk4", 1.0,
                 np.ones((B, 2, 8)))
    assert (k1.FWD_LAUNCHES, k1.BWD_LAUNCHES) == (0, 0)


def test_packing_matches_jax():
    H = 5
    coeffs, p = _problem(H, np.float32)
    c = jnp.asarray(coeffs)
    rows = tuple(c[..., i * C:(i + 1) * C] for i in (1, 2, 3))
    field_j = JaxField(*(jnp.asarray(p[k]) for k in ("w1", "b1", "w2", "b2")), H, C)
    packed_j = _pack_operands(*rows, jnp.asarray(p["z0"]), field_j, N, ct_store="native")

    field = MLPVectorField(H, C, W)
    with torch.no_grad():
        field.linear1.weight.copy_(torch.from_numpy(p["w1"].T))
        field.linear1.bias.copy_(torch.from_numpy(p["b1"]))
        field.linear2.weight.copy_(torch.from_numpy(p["w2"].T))
        field.linear2.bias.copy_(torch.from_numpy(p["b2"]))
    ct = torch.from_numpy(coeffs)
    packed = k1.pack_operands(*(ct[..., i * C:(i + 1) * C] for i in (1, 2, 3)),
                              torch.from_numpy(p["z0"]), field)

    # The JAX layout pads H to 8, C*H to 8, the batch to 128 lanes and each
    # interval's slab to 16 rows; the port keeps none of that padding.
    slab = np.asarray(packed_j.ct2).reshape(N, 16, -1)[:, :3 * C, :B]
    np.testing.assert_array_equal(packed.ct.numpy(), slab.reshape(N, 3, C, B))
    np.testing.assert_array_equal(packed.z0t.numpy(), np.asarray(packed_j.z0t)[:H, :B])
    np.testing.assert_array_equal(packed.w1t.detach().numpy(), np.asarray(packed_j.w1t)[:, :H])
    np.testing.assert_array_equal(packed.b1.detach().numpy(), np.asarray(packed_j.b1c)[:, 0])
    np.testing.assert_array_equal(packed.w2t.detach().numpy(), np.asarray(packed_j.w2t)[:C * H])
    np.testing.assert_array_equal(packed.b2.detach().numpy(), np.asarray(packed_j.b2c)[:C * H, 0])


def _field(H=8, C_=C, W_=W, dtype=torch.float64):
    return MLPVectorField(H, C_, W_, dtype=dtype)


def _rows(C_=C, dtype=torch.float64):
    return tuple(torch.zeros(4, N, C_, dtype=dtype) for _ in range(3))


def test_eligibility_declines():
    z0 = torch.zeros(4, 8, dtype=torch.float64)
    assert k1.try_fused_mlp(_rows(), z0, _field(), "rk4", 1, 1.0, N) is not None
    assert k1.try_fused_mlp(_rows(), z0, _field(), "dopri5", 1, 1.0, N) is None
    assert k1.try_fused_mlp(_rows(), z0, _field(), "rk4", 9, 1.0, N) is None
    assert k1.try_fused_mlp(_rows(), z0, _field(W_=513), "rk4", 1, 1.0, N) is None
    assert k1.try_fused_mlp(_rows(6), z0, _field(C_=6), "rk4", 1, 1.0, N) is None
    assert k1.try_fused_mlp(_rows(), z0.float(), _field(), "rk4", 1, 1.0, N) is None
    assert k1.try_fused_mlp(_rows(), z0, _field(), "rk4", 1, 1.0, N, out_knots=(0,)) is None
    # Shapes at the caps stay eligible.
    assert k1.try_fused_mlp(_rows(5), torch.zeros(4, 102, dtype=torch.float64),
                            _field(102, 5, 512), "rk4", 8, 1.0, N) is not None
    # bfloat16 takes the kernels' bfloat16 mode, returns bfloat16 and stays
    # near the float32 solve of the same quantized problem (bfloat16 keeps ~3
    # digits); mixed dtypes decline (tests/test_fused_pallas.py).
    bf = torch.bfloat16
    rng = np.random.default_rng(4)
    rows = tuple(torch.from_numpy(rng.standard_normal((4, N, C)) * 0.3).to(bf) for _ in range(3))
    z0 = torch.from_numpy(rng.standard_normal((4, 8))).to(bf)
    field = _field(dtype=bf)
    out = k1.try_fused_mlp(rows, z0, field, "rk4", 1, 1.0, N)
    ref = k1.try_fused_mlp(tuple(r.float() for r in rows), z0.float(), field.float(), "rk4", 1,
                           1.0, N)
    assert out.dtype == bf and ref.dtype == torch.float32
    np.testing.assert_allclose(out.detach().float().numpy(), ref.detach().numpy(), rtol=0.06,
                               atol=0.06)
    assert k1.try_fused_mlp(rows, z0.float(), field, "rk4", 1, 1.0, N) is None


@pytest.mark.parametrize("kwargs", [
    dict(method="bosh3"),
    dict(method="dopri8", adjoint=True),
    dict(method="rk4", options=dict(jump_t=np.array([1.0]))),
    dict(method="dopri5", options=dict(jump_t=np.array([1.0]))),
    dict(method="scipy_solver"),
])
def test_not_ported_options_raise(kwargs):
    """These options once raised NotImplementedError in the port; now each
    runs through the port and the JAX package, whose values and z0
    gradients agree within 1e-8 of their largest magnitudes (the fixed-step
    cases with jump_t warn on both sides, scipy_solver has no gradient).
    The path is linear in time, so that the adaptive meshes (scipy's too)
    do not part on rounding at the knots."""
    kwargs = dict(dict(adjoint=False, step_size=1.0), **kwargs)
    _coeffs, p = _problem(8, np.float64, seed=3)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 1, C)) + rng.standard_normal((4, 1, C)) * np.arange(N + 1)[:, None]
    coeffs = np.asarray(tc.hermite_cubic_coefficients_with_backward_differences(jnp.asarray(x)))
    z0 = p["z0"][:4]
    jkwargs = dict(kwargs)
    if "jump_t" in kwargs.get("options", {}):
        jkwargs["options"] = dict(jump_t=jnp.asarray(kwargs["options"]["jump_t"]))
    field_j = JaxField(*(jnp.asarray(p[k]) for k in ("w1", "b1", "w2", "b2")), 8, C)
    Xj = tc.CubicSpline(jnp.asarray(coeffs))
    grads = kwargs["method"] != "scipy_solver"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out_j = np.asarray(tc.cdeint(Xj, field_j, jnp.asarray(z0), Xj.interval, **jkwargs))
        g_j = np.asarray(jax.grad(lambda z: jnp.sum(tc.cdeint(
            Xj, field_j, z, Xj.interval, **jkwargs) ** 2))(jnp.asarray(z0))) if grads else None
        field = _field()
        with torch.no_grad():
            field.linear1.weight.copy_(torch.from_numpy(p["w1"].T))
            field.linear1.bias.copy_(torch.from_numpy(p["b1"]))
            field.linear2.weight.copy_(torch.from_numpy(p["w2"].T))
            field.linear2.bias.copy_(torch.from_numpy(p["b2"]))
        X = tt.CubicSpline(torch.from_numpy(coeffs))
        z = torch.tensor(z0, requires_grad=grads)
        out = tt.cdeint(X, field, z, X.interval, **kwargs)
        if grads:
            (out ** 2).sum().backward()
    scale = np.abs(out_j).max()
    np.testing.assert_allclose(out.detach().numpy(), out_j, rtol=0, atol=1e-8 * scale)
    if grads:
        np.testing.assert_allclose(z.grad.numpy(), g_j, rtol=0, atol=1e-8 * np.abs(g_j).max())


def test_general_integrator_matches_fused_path():
    # A closure is not an MLPVectorField, and t off the knot grid declines the
    # knot-aligned plan: both take the general fixed-step integrator.
    coeffs, p = _problem(5, np.float64)
    field = _field(5)
    X = tt.CubicSpline(torch.from_numpy(coeffs))
    z0 = torch.from_numpy(p["z0"])
    fused = tt.cdeint(X, field, z0, X.grid_points, adjoint=False, method="rk4", step_size=0.5)
    general = tt.cdeint(X, lambda t, z: field(t, z), z0, X.grid_points, adjoint=False,
                        method="rk4", step_size=0.5)
    torch.testing.assert_close(general, fused, rtol=1e-12, atol=1e-12)
    t = np.array([0.25, 3.75, 11.5])
    off_grid = tt.cdeint(X, field, z0, t, adjoint=False, method="rk4", step_size=0.25)
    expected = tc.cdeint(
        tc.CubicSpline(jnp.asarray(coeffs)),
        JaxField(*(jnp.asarray(v) for v in (
            field.linear1.weight.detach().numpy().T, field.linear1.bias.detach().numpy(),
            field.linear2.weight.detach().numpy().T, field.linear2.bias.detach().numpy())), 5, C),
        jnp.asarray(p["z0"]), t, adjoint=False, method="rk4", step_size=0.25)
    np.testing.assert_allclose(off_grid.detach().numpy(), np.asarray(expected), rtol=1e-9, atol=1e-11)


def _plain_field(dtype):
    """An H 8 field holding ``_problem``'s weights, in dtype."""
    _, p = _problem(8, np.float32, seed=7)
    field = MLPVectorField(8, C, W, dtype=dtype)
    with torch.no_grad():
        field.linear1.weight.copy_(torch.from_numpy(p["w1"].T))
        field.linear1.bias.copy_(torch.from_numpy(p["b1"]))
        field.linear2.weight.copy_(torch.from_numpy(p["w2"].T))
        field.linear2.bias.copy_(torch.from_numpy(p["b2"]))
    return field


def _fused_solve_and_grads(field, dtype):
    """try_fused_mlp over fixed rows and z0 in dtype (rk4, two substeps per
    interval, three output knots): the solution and the gradients of a fixed
    projection of it with respect to the rows, z0 and the field's weights."""
    rng = np.random.default_rng(8)
    rows = [torch.from_numpy(rng.standard_normal((B, N, C)) * 0.3).to(dtype).requires_grad_()
            for _ in range(3)]
    z0 = torch.from_numpy(rng.standard_normal((B, 8))).to(dtype).requires_grad_()
    proj = torch.from_numpy(rng.standard_normal((3, B, 8))).float()
    field.zero_grad(set_to_none=True)
    out = k1.try_fused_mlp(rows, z0, field, "rk4", 2, 0.5, N, out_knots=(0, 5, N))
    (out.float() * proj).sum().backward()
    return [out.detach()] + [r.grad for r in rows] + [z0.grad] + [
        q.grad for q in (field.linear1.weight, field.linear1.bias, field.linear2.weight,
                         field.linear2.bias)]


@pytest.mark.parametrize("blocks", [1, 3])  # one block; several, whose lanes stride
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])  # the slab table's modes
def test_backward_launch_wrapper_with_plain_stand_ins(dtype, blocks, monkeypatch):
    """The kernels run only on the card: stand-ins for the forward launch
    (the plain forward, counting) and for the backward kernel (autograd
    through the plain version, its weight gradients split over the plan's
    blocks) drive the autograd Function and the backward wrapper's own code,
    which sizes the partials from the plan (``backward_plan``, stood in for)
    and sums them in block order.  One forward and one backward launch per
    solve, in the slab table's mode; the gradients are the plain route's up
    to the split's rounding (float32: 1e-6 of each gradient's largest
    magnitude; bfloat16 weights: one bfloat16 step, 2^-7 of it, since a
    float32 difference in the last bit can round to either neighbour)."""
    mode = int(dtype == torch.bfloat16)
    launch = dict(streamed=0, blocks=blocks, threads=256, lanes_per_block=32, threads_per_lane=8,
                  slices=1, resident_per_sm=1, sms=blocks, shared_bytes=0, scratch_floats=0)
    field = _plain_field(dtype)
    expected = _fused_solve_and_grads(field, dtype)

    def forward(ct, z0t, w1t, b1, w2t, b2, plan):
        k1.FWD_LAUNCHES += 1
        k1.BF16_FWD_LAUNCHES += int(ct.dtype == torch.bfloat16)
        n = ct.shape[0]
        with torch.no_grad():
            zres = k1.fused_fixed_solve_reference(ct, z0t, w1t, b1, w2t, b2, plan.method, plan.m,
                                                  plan.dt_sub, tuple(range(1, n + 1)))
        return zres[[k - 1 for k in plan.out_knots]], zres

    def planned(B_, H, C_, W_, plan, mode_, device):
        assert (B_, H, C_, W_, mode_) == (B, 8, C, W, mode) and device == torch.device("cpu")
        return launch

    def backward_kernel(ops, outs, shape, plan, mode_, planned_launch):
        assert planned_launch is launch and shape == (B, N, 8, C, W) and mode_ == mode
        ct, zres, z0t, gz, w1t, b1, w2t, b2 = ops
        leaves = [t.detach().requires_grad_() for t in (ct, z0t, w1t, b1, w2t, b2)]
        with torch.enable_grad():
            ref = k1.fused_fixed_solve_reference(*leaves, plan.method, plan.m, plan.dt_sub,
                                                 plan.out_knots)
            dct, dz0, dw1t, db1, dw2t, db2 = torch.autograd.grad(ref, leaves, gz)
        assert outs[0].dtype == ct.dtype and all(o.dtype == torch.float32 for o in outs[1:])
        outs[0].copy_(dct)
        outs[1].copy_(dz0)
        shares = torch.arange(1.0, blocks + 1) / (blocks * (blocks + 1) / 2)
        for partial, grad in zip(outs[2:], (dw1t, db1, dw2t.t(), db2)):
            assert partial.shape == (blocks,) + grad.shape
            partial.copy_(shares.reshape((blocks,) + (1,) * grad.dim()) * grad)

    def solve(ct, z0t, w1t, b1, w2t, b2, method, m, dt_sub, out_knots):
        return k1._FusedFixedSolve.apply(ct, z0t, w1t, b1, w2t, b2,
                                         k1._Plan(method, m, dt_sub, tuple(out_knots)))

    monkeypatch.setattr(k1, "launch_forward", forward)
    monkeypatch.setattr(k1, "backward_plan", planned)
    monkeypatch.setattr(k1, "_backward_kernel", backward_kernel)
    monkeypatch.setattr(k1, "check_operands", lambda *a, **k: None)
    monkeypatch.setattr(k1, "fused_fixed_solve", solve)
    k1.reset_launch_counts()
    got = _fused_solve_and_grads(field, dtype)
    assert (k1.FWD_LAUNCHES, k1.BWD_LAUNCHES) == (1, 1)
    assert (k1.BF16_FWD_LAUNCHES, k1.BF16_BWD_LAUNCHES) == (mode, mode)
    k1.reset_launch_counts()
    names = ["solution", "b", "two_c", "three_d", "z0", "w1", "b1", "w2", "b2"]
    for name, g, e in zip(names, got, expected):
        assert g.dtype == e.dtype, name
        if name in ("solution", "b", "two_c", "three_d", "z0"):
            torch.testing.assert_close(g, e, rtol=1e-6, atol=0.0, msg=name)
            continue
        step = 2.0 ** -7 if mode else 1e-6
        scale = float(e.abs().max())
        torch.testing.assert_close(g.float(), e.float(), rtol=0.0, atol=step * scale, msg=name)


@pytest.mark.parametrize("blocks", [1, 3])  # one block; several, whose lanes stride
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])  # the slab table's modes
def test_forward_launch_wrapper_with_plain_stand_ins(dtype, blocks, monkeypatch):
    """The forward kernel runs only on the card: stand-ins for its plan
    (``forward_plan``) and for the kernel (the plain forward into the
    wrapper's outputs) drive the forward wrapper's own code, which plans the
    launch, allocates the outputs and passes the plan's blocks on.  One
    forward launch per solve, in the slab table's mode, and the solution is
    the plain route's."""
    mode = int(dtype == torch.bfloat16)
    launch = dict(streamed=0, blocks=blocks, threads=64, lanes_per_block=8, threads_per_lane=8,
                  slices=1, resident_per_sm=8, sms=blocks, shared_bytes=18528, scratch_floats=0)
    field = _plain_field(dtype)
    expected = _fused_solve_and_grads(field, dtype)[0]
    seen = []

    def planned(B_, H, C_, W_, plan, mode_, device):
        assert (B_, H, C_, W_, mode_) == (B, 8, C, W, mode) and device == torch.device("cpu")
        return launch

    def forward_kernel(ops, outs, shape, plan, mode_, planned_launch):
        assert planned_launch is launch and shape == (B, N, 8, C, W) and mode_ == mode
        out, zres = outs
        assert out.shape == (len(plan.out_knots), 8, B) and zres.shape == (N, 8, B)
        assert out.dtype == zres.dtype == torch.float32 and ops[0].dtype == dtype
        with torch.no_grad():
            zres.copy_(k1.fused_fixed_solve_reference(*ops, plan.method, plan.m, plan.dt_sub,
                                                      tuple(range(1, N + 1))))
        out.copy_(zres[[k - 1 for k in plan.out_knots]])
        seen.append(plan)

    def solve(ct, z0t, w1t, b1, w2t, b2, method, m, dt_sub, out_knots):
        return k1._FusedFixedSolve.apply(ct, z0t, w1t, b1, w2t, b2,
                                         k1._Plan(method, m, dt_sub, tuple(out_knots)))

    monkeypatch.setattr(k1, "forward_plan", planned)
    monkeypatch.setattr(k1, "_forward_kernel", forward_kernel)
    monkeypatch.setattr(k1, "check_operands", lambda *a, **k: None)
    monkeypatch.setattr(k1, "fused_fixed_solve", solve)
    k1.reset_launch_counts()
    rng = np.random.default_rng(8)
    rows = [torch.from_numpy(rng.standard_normal((B, N, C)) * 0.3).to(dtype) for _ in range(3)]
    z0 = torch.from_numpy(rng.standard_normal((B, 8))).to(dtype)
    with torch.no_grad():
        got = k1.try_fused_mlp(rows, z0, field, "rk4", 2, 0.5, N, out_knots=(0, 5, N))
    assert (k1.FWD_LAUNCHES, k1.BWD_LAUNCHES) == (1, 0)
    assert (k1.BF16_FWD_LAUNCHES, k1.BF16_BWD_LAUNCHES) == (mode, 0)
    assert [p.out_knots for p in seen] == [(5, N)]
    k1.reset_launch_counts()
    assert got.dtype == expected.dtype
    torch.testing.assert_close(got, expected, rtol=1e-6, atol=0.0)


# A numpy mirror of the CUDA kernels' lane group (csrc/fused_fixed.cuh,
# fused_fixed_bwd.cu): one stage evaluation and its VJP as the group
# computes them, held against the plain version.  A lane's G threads are GS
# state slices of HS components (H padded to Hp = GS HS with zero weights,
# per channel) times GW row threads; thread (s, rw) walks the hidden rows
# w = rw (mod GW) in order, its slice's part of W1[w] . y summed over the
# slices by a butterfly, the slice's C HS pre-activations summed over its row
# threads by a butterfly that scatters them and a second that gathers them;
# in the VJP dh_w and ddx are summed over the slices and dy over the row
# threads.  The weight gradients reduce over the block's lanes in units of 4
# rows x 4 columns (chunks of 128 rows), each real cell in one unit.  In the
# bfloat16 mode the operands round where the kernels round them, with the
# padded layout's selection roundings where H % 8 != 0.


def _slicing(H, C):
    """(HS, GS, GW, Hp), as fused_fixed.cuh's slicing() picks them."""
    HS = 16 if C == 1 and H > 256 else 8
    GS = 1
    while GS * HS < H:
        GS *= 2
    Hp = GS * HS
    return HS, GS, (8 if Hp <= 32 else 1), Hp


def _small_batch_lanes(lanes, G, B, sms, least=32, fits=lambda lanes: True):
    """fused_fixed.cuh's small_batch_lanes: lanes a block halved while the
    lane groups are fewer than half the SMs, the block keeps `least` threads
    and fits(the halved lanes) holds."""
    while 2 * -(-B // lanes) < sms and lanes * G // 2 >= least and fits(lanes // 2):
        lanes //= 2
    return lanes


def _backward_lanes(B, H, C, W, sms):
    """The backward's small-batch rule (fused_fixed_bwd.cuh backward_plan):
    halved only while each thread's units of the weight gradients (units of
    4 rows x 4 columns, chunks of 128 rows) stay in its two registers'
    tiles."""
    _, GS, GW, Hp = _slicing(H, C)
    G, NB, chunks = GS * GW, (1 + C) * Hp // 4, -(-(-(-W // 8) * 8) // 128)

    def units(lanes):
        return chunks * -(-(32 * NB) // (lanes * G))

    return _small_batch_lanes(256 // G, G, B, sms, 32, lambda lanes: units(lanes) <= 2)


def _r(x, mx):
    """x rounded to bfloat16 (float32 kept) when mx, else x."""
    if not mx:
        return x
    return torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16).float().numpy()


def _slice_butterfly(parts):
    """The sum over the slices (axis 0) by the kernels' xor butterfly: the
    same bits in every slice."""
    G, o = parts.shape[0], 1
    while o < G:
        parts = parts + parts[np.arange(G) ^ o]
        o *= 2
    assert all(np.array_equal(parts[0], p) for p in parts)
    return parts[0]


def _scatter_gather(pre, GW):
    """pre (GW, L, N) of the row threads: the sums over them as Scatter
    leaves them (thread rw owning entries [rw N/GW, (rw+1) N/GW)), then
    gathered; returns (L, N)."""
    GWn, L, N = pre.shape
    live = [pre[rw].copy() for rw in range(GW)]
    own = [np.arange(N) for _ in range(GW)]
    M = GW // 2
    while M >= 1:
        new, new_own = [], []
        for rw in range(GW):
            half = live[rw].shape[1] // 2
            hi = bool(rw & M)
            keep = live[rw][:, half:] if hi else live[rw][:, :half]
            partner = live[rw ^ M][:, half:] if hi else live[rw ^ M][:, :half]
            new.append(keep + partner)
            new_own.append(own[rw][half:] if hi else own[rw][:half])
        live, own, M = new, new_own, M // 2
    out = np.zeros((L, N), np.float32)
    for rw in range(GW):
        assert np.array_equal(own[rw], np.arange(rw * N // GW, (rw + 1) * N // GW))
        out[:, own[rw]] = live[rw]
    return out


def _row_butterfly(parts):
    """parts (GW, ...) summed over the row threads by row_sum's butterfly."""
    GW, m = parts.shape[0], 1
    while m < GW:
        parts = parts + parts[np.arange(GW) ^ m]
        m *= 2
    return parts[0]


def _group_step(ct, z0t, w1t, b1, w2t, b2, gz, mx, threads):
    """One euler step over one interval (one evaluation at fraction 0) and
    its VJP for the cotangent gz, by the mirror of the lane group: (out,
    dct, dz0, dw1t, db1, dw2t, db2), float32."""
    f32 = np.float32
    _, _, C, L = ct.shape
    W, H = w1t.shape
    HS, GS, GW, Hp = _slicing(H, C)
    rows = -(-W // 8) * 8
    RS = (1 + C) * Hp + 4
    rec = np.zeros((rows, RS), f32)  # csrc/cde_stream.cuh's records
    rec[:W, :H] = w1t
    for i in range(C):
        rec[:W, (1 + i) * Hp:(1 + i) * Hp + H] = w2t[i * H:(i + 1) * H].T
    rec[:W, (1 + C) * Hp] = b1
    b2s = np.zeros((C, Hp), f32)
    b2s[:, :H] = b2.reshape(C, H)
    y = np.zeros((L, Hp), f32)
    y[:, :H] = z0t.T
    u = np.zeros((L, Hp), f32)
    u[:, :H] = gz.T
    sel = mx and H % 8 != 0
    dx = ct[0, 0].T.astype(f32)  # b + (2c + 3d fr) fr at fr 0
    yr = _r(y, mx)
    w1 = rec[:, :Hp].reshape(rows, GS, HS)
    w2 = rec[:, Hp:(1 + C) * Hp].reshape(rows, C, GS, HS)
    # h1: each slice's dot in order, summed over the slices.
    part = np.zeros((GS, L, rows), f32)
    for j in range(HS):
        part = part + np.einsum("wg,lg->glw", w1[:, :, j], yr.reshape(L, GS, HS)[:, :, j])
    h1 = np.maximum(_slice_butterfly(part) + rec[:, (1 + C) * Hp], f32(0))
    # The second layer: each row thread's rows in order, then scatter/gather.
    g = np.zeros((L, C, GS, HS), f32)
    h1r = _r(h1, mx)
    for s in range(GS):
        pre = np.zeros((GW, L, C * HS), f32)
        for w in range(rows):
            pre[w % GW] = pre[w % GW] + h1r[:, w, None] * w2[w, :, s].reshape(1, C * HS)
        g[:, :, s] = np.tanh(_scatter_gather(pre, GW) + b2s[:, s * HS:(s + 1) * HS].reshape(
            1, C * HS)).reshape(L, C, HS)
    g = g.reshape(L, C, Hp)
    dxr = _r(dx, sel)
    if sel:
        k = np.zeros((L, Hp), f32)
        for i in range(C):
            k = k + _r(g[:, i] * dxr[:, i:i + 1], True)
    else:
        k = g[:, 0] * dx[:, 0:1]
        for i in range(1, C):
            k = k + g[:, i] * dx[:, i:i + 1]
    # The VJP.
    ur = _r(u, sel)
    acc = np.zeros((GS, L, C), f32)
    for j in range(HS):
        for s in range(GS):
            h = s * HS + j
            term = ur[:, None, h] * g[:, :, h]
            acc[s] = acc[s] + (_r(term, True) if sel else term)
    ddx = _slice_butterfly(acc)
    dp2 = (ur[:, None, :] * dxr[:, :, None]) * (f32(1) - g * g)  # (L, C, Hp)
    dp2r = _r(dp2, mx)
    dh_part = np.zeros((GS, L, rows), f32)
    for i in range(C):
        for j in range(HS):
            dh_part = dh_part + np.einsum("wg,lg->glw", w2[:, i, :, j],
                                          dp2r[:, i].reshape(L, GS, HS)[:, :, j])
    p = np.where(h1 > 0, _slice_butterfly(dh_part), f32(0))
    pr = _r(p, mx)
    dy_part = np.zeros((GW, L, Hp), f32)
    for w in range(rows):
        dy_part[w % GW] = dy_part[w % GW] + pr[:, w, None] * rec[w, :Hp]
    dy = _row_butterfly(dy_part)
    # The weight gradients: units of 4 rows x 4 columns over the lanes, in
    # order; columns q = i Hp + h of dp2, then h of y.
    right = np.concatenate([dp2r.reshape(L, C * Hp), yr], axis=1)
    NB, NBQ = (1 + C) * Hp // 4, C * Hp // 4
    upc = -(-(32 * NB) // threads)
    dw2 = np.zeros((W, C * H), f32)
    dw1 = np.zeros((W, H), f32)
    db1 = np.zeros(W, f32)
    db2 = np.zeros(C * H, f32)
    covered = np.zeros((W, (1 + C) * H + 1), int)
    for c in range(-(-rows // 128)):
        for tid in range(threads):
            for jj in range(upc):
                k4, b = divmod(tid + jj * threads, NB)
                r0 = c * 128 + 4 * k4
                if 4 * k4 >= 128 or r0 >= rows:
                    continue
                left = _r(p if b >= NBQ else h1, mx)[:, r0:r0 + 4]
                cols = right[:, 4 * b:4 * b + 4]
                tile = np.zeros((4, 4), f32)
                for lane in range(L):
                    tile = tile + left[lane][:, None] * cols[lane][None, :]
                for e in range(4):
                    w = r0 + e
                    if w >= W:
                        continue
                    for jc in range(4):
                        q = 4 * b + jc
                        if b < NBQ:
                            i, h = divmod(q, Hp)
                            if h < H:
                                dw2[w, i * H + h] += tile[e, jc]
                                covered[w, i * H + h] += 1
                        elif q - C * Hp < H:
                            dw1[w, q - C * Hp] += tile[e, jc]
                            covered[w, C * H + q - C * Hp] += 1
                    if b == NBQ:
                        db1[w] += p[:, w].sum(dtype=f32)
                        covered[w, -1] += 1
                if c == 0 and k4 == 0 and b < NBQ:
                    for jc in range(4):
                        i, h = divmod(4 * b + jc, Hp)
                        if h < H:
                            db2[i * H + h] += dp2[:, i, h].sum(dtype=f32)
    assert (covered == 1).all()
    dct = np.zeros(ct.shape, f32)
    dct[0, 0] = ddx.T
    out = (y + k)[:, :H].T
    return out, dct, (u + dy)[:, :H].T, dw1, db1, dw2.T, db2


# (H, C, W): the flagship's H 8, C 3 (one slice, 8 row threads); H 5 and 7
# padded to one slice (the bfloat16 mode's selection roundings); H 16 in two
# slices, at W 128 and with C 5 at the caps' width; H 100 in sixteen slices
# of one row thread each (Hp 128).
MIRROR_SHAPES = [(8, 3, 128), (5, 3, 128), (7, 2, 64), (16, 3, 128), (16, 5, 512),
                 (100, 5, 16)]


@pytest.mark.parametrize("mode", [0, 1], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("H, C_, W_", MIRROR_SHAPES, ids=[f"H{h}C{c}W{w}" for h, c, w in MIRROR_SHAPES])
def test_lane_group_mirror_matches_the_plain_version(H, C_, W_, mode):
    # float32: within 1e-6 of each output's largest magnitude (the plain
    # version in float64; the mirror sums in float32 in the kernels' order).
    # bfloat16: within one bfloat16 step (2^-7 of the largest magnitude) of
    # the plain bfloat16 version, whose roundings a sum order may flip.
    L = 6
    rng = np.random.default_rng(H * 100 + C_)
    f32 = np.float32
    ops = [rng.standard_normal((1, 3, C_, L)).astype(f32) * f32(0.3),
           rng.standard_normal((H, L)).astype(f32),
           (rng.uniform(-1, 1, (W_, H)) / np.sqrt(H)).astype(f32),
           (rng.uniform(-1, 1, W_) / np.sqrt(H)).astype(f32),
           (rng.uniform(-1, 1, (C_ * H, W_)) / np.sqrt(W_)).astype(f32),
           (rng.uniform(-1, 1, C_ * H) / np.sqrt(W_)).astype(f32)]
    gz = rng.standard_normal((H, L)).astype(f32)
    mx = bool(mode)
    if mx:
        ops = [_r(a, True) for a in ops]
    _, GS, GW, _ = _slicing(H, C_)
    threads = _backward_lanes(L, H, C_, W_, 132) * GS * GW
    got = _group_step(*ops, gz, mx, threads)
    if mx:
        leaves = [torch.from_numpy(ops[0]).to(torch.bfloat16).requires_grad_()] + [
            torch.from_numpy(a).requires_grad_() for a in ops[1:]]
    else:
        leaves = [torch.from_numpy(a).double().requires_grad_() for a in ops]
    ref = k1.fused_fixed_solve_reference(*leaves, "euler", 1, 1.0, (1,))
    grads = torch.autograd.grad(ref, leaves, torch.from_numpy(gz)[None].to(ref.dtype))
    names = ["solution", "ct", "z0", "w1", "b1", "w2", "b2"]
    for name, g, e in zip(names, got, [ref[0]] + list(grads)):
        e = e.detach().float().numpy().astype(np.float64) if mx else e.detach().numpy()
        scale = max(float(np.abs(e).max()), 1e-30)
        np.testing.assert_allclose(g, e, rtol=0, atol=(2.0 ** -7 if mx else 1e-6) * scale,
                                   err_msg=name)


@pytest.mark.parametrize("B, H, C_, W_, fwd, bwd", [
    (4096, 8, 3, 128, 8, 32),   # the flagship: its plans as before the rule
    (4096, 16, 3, 128, 8, 16),
    (4096, 32, 3, 128, 8, 8),
    (1000, 8, 3, 128, 8, 16),   # 32 groups: the backward halves once, its units in registers
    (520, 8, 3, 64, 8, 16),     # the forward keeps two warps a block
    (520, 16, 5, 512, 4, 16),   # the backward's units already past its registers
    (300, 100, 5, 512, 4, 16),
    (300, 8, 3, 500, 8, 32),
])
def test_small_batch_rule_on_a_stand_in_plan(B, H, C_, W_, fwd, bwd):
    # The rule on a stand-in of the card's plan (132 SMs), as the CUDA
    # sources apply it: where the lane groups are fewer than half the SMs,
    # the forward halves its lanes a block while a block keeps two warps, the
    # backward while each thread's weight-gradient units stay in registers
    # (on an H100, halving past either cost more than it spread: PERF.md, PR
    # 22).  The flagship's plans at B 4096 keep their lanes in both
    # directions.
    _, GS, GW, _ = _slicing(H, C_)
    assert _small_batch_lanes(8, GS * GW, B, 132, 64) == fwd
    assert _backward_lanes(B, H, C_, W_, 132) == bwd


# K8's backward (csrc/fused_reversible_bwd.cu backward_plan) on its group
# path takes twice the threads a lane (slices of 4 components) where its lane
# groups are fewer than half the SMs; its lanes a block stay 256 / G.
def _k8_group_plan(B, H, C, sms):
    """(components a thread, threads a lane, lanes a block)."""
    HS = 16 if C == 1 and H > 256 else 8
    G = 1
    while G * HS < H:
        G *= 2
    if G == 1:
        return HS, 1, 128  # one thread a lane: 128 lanes at compile time
    if HS == 8 and 2 * G <= 32 and 2 * -(-B // (256 // G)) < sms:
        HS, G = 4, 2 * G
    return HS, G, 256 // G


@pytest.mark.parametrize("B, H, C_, plan", [
    (16384, 8, 3, (8, 1, 128)), (16384, 16, 3, (8, 2, 128)), (16384, 32, 3, (8, 4, 64)),
    (520, 16, 5, (4, 4, 64)),   # config 5's: as before the rule; 5 groups of 128 lanes: split
    (300, 100, 5, (4, 32, 8)),
    (300, 8, 3, (8, 1, 128)),   # one thread a lane: unchanged
])
def test_k8_small_batch_rule_on_a_stand_in_plan(B, H, C_, plan):
    assert _k8_group_plan(B, H, C_, 132) == plan
