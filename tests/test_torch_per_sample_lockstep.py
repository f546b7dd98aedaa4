"""The lockstep per-sample solve (``solvers/per_sample.py``) against the JAX
package's vmapped per-sample path, in float64 on the CPU.

``options={'per_sample': True}`` outside the fused kernel K9 runs every lane
in one lockstep solve: each lane its own time, step size, controller and
budget.  The JAX package vmaps a one-sample solve (its fused routes off).
Values within 1e-9 of the largest magnitude, per-lane statistics equal,
gradients within 1e-8; paths linear in time (``tests/test_torch_per_sample.py``
says why).  Besides: the host reads from the device once per lockstep
iteration, the field is called once per stage of an iteration for all lanes,
a lane solved alone gives the same bits as in its batch, the backsolve
reaches a field's weights wherever it holds them (a closure, a global, an
attribute, a dict, list or tuple), and a field that vmap cannot take raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_per_sample import H, _close, _problem, _torch, jax_general_path  # noqa: F401
import torchcde_tpu as tc
import torchcde_tpu_torch as tt
from torchcde_tpu.solvers.terms import MLPVectorField as JaxField
from torchcde_tpu_torch.solvers import per_sample
from torchcde_tpu_torch.solvers.terms import MLPVectorField

torch.set_num_threads(1)

B, C = 4, 3


def _rows(batch, length):
    """Batched output times: five per lane over [0, t_end], ends spread."""
    ends = np.linspace(0.55, 1.0, batch) * (length - 1)
    return np.stack([np.linspace(0.0, e, 5) for e in ends])


def _control(lib, x, kind):
    if kind == "linear":
        return lib.LinearInterpolation(lib.linear_interpolation_coeffs(x))
    if kind == "rectilinear":
        return lib.LinearInterpolation(lib.linear_interpolation_coeffs(x, rectilinear=0))
    return lib.CubicSpline(lib.hermite_cubic_coefficients_with_backward_differences(x))


def _field(ns, W, reads_t=False):
    if ns == "jax":
        if reads_t:
            return lambda s, z: jnp.tanh(z)[..., None] * W * jnp.cos(0.3 * s)
        return lambda s, z: jnp.tanh(z)[..., None] * W
    if reads_t:
        return lambda s, z: (torch.tanh(z)[..., None] * W
                             * torch.cos(0.3 * torch.as_tensor(s, dtype=torch.float64)))
    return lambda s, z: torch.tanh(z)[..., None] * W


def _solve(ns, x, W, z0, t=None, kind="cubic", reads_t=False, jump_t=None, **kwargs):
    lib = tc if ns == "jax" else tt
    X = _control(lib, x, kind)
    options = dict(per_sample=True)
    if jump_t is not None:
        options["jump_t"] = jnp.asarray(jump_t) if ns == "jax" else jump_t
    return lib.cdeint(X=X, func=_field(ns, W, reads_t), z0=z0,
                      t=X.interval if t is None else t, options=options, **kwargs)


def _both(x, W, z0, t=None, **kwargs):
    """(the JAX solve, the port's) with stats, each on its own arrays."""
    got = _solve("torch", *_torch(x, W, z0), None if t is None else _torch(t)[0],
                 adjoint=False, return_stats=True, **kwargs)
    expected = _solve("jax", *map(jnp.asarray, (x, W, z0)), None if t is None else jnp.asarray(t),
                      adjoint=False, return_stats=True, **kwargs)
    return got, expected


def _check(got, expected):
    (out, stats), (out_j, stats_j) = got, expected
    out, out_j = out.numpy(), np.asarray(out_j)
    assert out.shape == out_j.shape
    np.testing.assert_array_equal(np.isnan(out), np.isnan(out_j))
    finite = ~np.isnan(out_j)
    _close(out[finite], out_j[finite], 1e-9)
    for name, value in stats_j.items():
        np.testing.assert_array_equal(stats[name].numpy(), np.asarray(value), err_msg=name)


@pytest.mark.parametrize("times", ["shared", "batched"])
@pytest.mark.parametrize("method", ["dopri5", "dopri5_nofsal", "bosh3", "dopri8",
                                    "adaptive_heun", "fehlberg2"])
def test_every_adaptive_method_matches_jax(method, times):
    x, W, z0 = _problem(batch_shape=(B,), length=8, spread=0.3)
    t = _rows(B, 8) if times == "batched" else None
    got, expected = _both(x, W, z0, t, method=method, rtol=1e-5, atol=1e-7)
    _check(got, expected)
    if times == "shared":
        nfe = got[1]["nfe"].numpy()
        assert nfe.min() < nfe.max()  # each lane's own steps


CASES = {
    "jump_t dopri5": dict(method="dopri5", jump_t=np.array([4.5, 2.5])),
    "jump_t dopri8 batched": dict(method="dopri8", jump_t=np.array([1.5, 3.0]), t="rows"),
    "batch (2, 3)": dict(method="bosh3", batch_shape=(2, 3)),
    "field reads t": dict(method="dopri5", reads_t=True, t="rows"),
    "linear control": dict(method="dopri5", kind="linear", t="knots"),
    "rectilinear control": dict(method="bosh3", kind="rectilinear", t="knots"),
    "exhausted dopri5": dict(method="dopri5", max_steps=4),
    "exhausted dopri8": dict(method="dopri8", rtol=1e-8, atol=1e-10, max_steps=2, t="rows"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cases_match_jax(case):
    kw = dict(CASES[case])
    shape = kw.pop("batch_shape", (B,))
    x, W, z0 = _problem(batch_shape=shape, length=7, spread=0.3)
    which = kw.pop("t", None)
    if kw.get("kind") == "rectilinear":
        # A time channel first, then the values; the knots are 0..2L-2.
        x = np.concatenate([np.broadcast_to(np.arange(7.0)[:, None], shape + (7, 1)), x], -1)
        W = np.concatenate([W, W[:, :1]], -1)
    n_knots = 2 * 7 - 1 if kw.get("kind") == "rectilinear" else 7
    t = {"rows": _rows(int(np.prod(shape)), 7),
         # Output times on knots: a linear control's slope there is the
         # left interval's, in each lane.
         "knots": np.array([0.0, 2.0, 3.0, n_knots - 1.0]),
         None: None}[which]
    got, expected = _both(x, W, z0, t, **kw)
    _check(got, expected)
    out = got[0].reshape(-1, *got[0].shape[-2:])
    if case.startswith("exhausted"):
        # Only the lanes whose budget ran out are NaN, as in JAX.
        lost = torch.isnan(out).any(dim=(1, 2))
        assert 0 < int(lost.sum()) < out.shape[0]
        assert torch.isfinite(out[~lost]).all()
    else:
        assert torch.isfinite(out).all()


def _mlp(ns, p):
    if ns == "jax":
        return JaxField(p["w1"], p["b1"], p["w2"], p["b2"], H, C)
    field = MLPVectorField(H, C, 8, dtype=torch.float64)
    with torch.no_grad():
        for layer, w, b in ((field.linear1, "w1", "b1"), (field.linear2, "w2", "b2")):
            layer.weight.copy_(torch.from_numpy(p[w].T))
            layer.bias.copy_(torch.from_numpy(p[b]))
    return field


class _TanhModule(torch.nn.Module):
    """``_field``'s field as a module: the backsolve finds W among its
    parameters."""

    def __init__(self, W):
        super().__init__()
        self.W = torch.nn.Parameter(W.detach().clone())

    def forward(self, s, z):
        return torch.tanh(z)[..., None] * self.W


GRADIENTS = {
    "dopri5 direct": dict(adjoint=False),
    "dopri8 direct, batched times": dict(adjoint=False, method="dopri8", t="rows"),
    "adaptive_heun adjoint, module field, own tolerances, batched times": dict(
        adjoint=True, method="adaptive_heun", module=True, adjoint_rtol=3e-4,
        adjoint_atol=3e-6, t="rows"),
    "bosh3 adjoint, rk4 backsolve": dict(adjoint=True, method="bosh3", adjoint_method="rk4",
                                         adjoint_options=dict(step_size=0.5)),
    "dopri5 adjoint, implicit_adams backsolve, batched times": dict(
        adjoint=True, adjoint_method="implicit_adams", adjoint_options=dict(step_size=0.5),
        t="rows"),
    "MLP direct, jump_t": dict(adjoint=False, mlp=True, jump_t=np.array([3.5])),
}


@pytest.mark.parametrize("case", list(GRADIENTS))
def test_gradients_match_jax(case):
    """Gradients of the control's data, the field's tensors, z0 and the
    output times (shared or batched)."""
    kw = dict(GRADIENTS[case])
    mlp, module = kw.pop("mlp", False), kw.pop("module", False)
    which, jump_t = kw.pop("t", None), kw.pop("jump_t", None)
    x, W, z0 = _problem(batch_shape=(3,), length=6, spread=0.3)
    rng = np.random.default_rng(5)
    p = dict(w1=rng.standard_normal((H, 8)) * 0.4, b1=rng.standard_normal(8) * 0.2,
             w2=rng.standard_normal((8, H * C)) * 0.3, b2=rng.standard_normal(H * C) * 0.2)
    t = _rows(3, 6) if which == "rows" else np.array([0.0, 5.0])
    proj = rng.standard_normal((3, H))

    def run(lib, x_, z0_, t_, field):
        X = lib.CubicSpline(lib.hermite_cubic_coefficients_with_backward_differences(x_))
        options = dict(per_sample=True)
        if jump_t is not None:
            options["jump_t"] = jnp.asarray(jump_t) if lib is tc else jump_t
        return lib.cdeint(X, field, z0_, t_, options=options, **kw)

    def loss_j(x_, W_, z0_, t_, p_):
        out = run(tc, x_, z0_, t_, _mlp("jax", p_) if mlp else _field("jax", W_))
        return jnp.sum(out[..., -1, :] * proj) + jnp.sum(jnp.sin(out))

    args_j = [jnp.asarray(v) for v in (x, W, z0, t)] + [{k: jnp.asarray(v) for k, v in p.items()}]
    grads_j = jax.grad(loss_j, argnums=(0, 1, 2, 3, 4))(*args_j)

    leaves = [v.requires_grad_() for v in _torch(x, W, z0, t)]
    if mlp:
        field = _mlp("torch", p)
    elif module:
        field = _TanhModule(leaves[1])
    else:
        field = _field("torch", leaves[1])
    out = run(tt, leaves[0], leaves[2], leaves[3], field)
    loss = (out[..., -1, :] * torch.from_numpy(proj)).sum() + torch.sin(out).sum()
    loss.backward()
    if module:
        leaves[1] = field.W
    for name, leaf, expected in zip(("x", "W", "z0", "t"), leaves, grads_j):
        if mlp and name == "W":
            continue  # the field does not read W
        _close(leaf.grad, expected, 1e-8, name)
    if mlp:
        for name, param in (("w1", field.linear1.weight), ("b1", field.linear1.bias),
                            ("w2", field.linear2.weight), ("b2", field.linear2.bias)):
            got = param.grad.T if name.startswith("w") else param.grad
            _close(got, grads_j[4][name], 1e-8, name)


def _apply(lib, params, z):
    """A two-layer field over weights held in a pytree: a dict, a tuple, a
    list, or a dict holding a tuple."""
    if isinstance(params, dict) and "layer1" in params:
        (w1, b1), (w2, b2) = params["layer1"], params["layer2"]
    elif isinstance(params, dict):
        w1, b1, w2, b2 = (params[k] for k in ("w1", "b1", "w2", "b2"))
    else:
        w1, b1, w2, b2 = params
    h = lib.tanh(z @ w1 + b1)
    return (h @ w2 + b2).reshape(z.shape[:-1] + (H, C))


def _pytree(kind, w):
    """The weights (w1, b1, w2, b2) held as ``kind``."""
    if kind == "dict":
        return dict(zip(("w1", "b1", "w2", "b2"), w))
    if kind == "nested":
        return {"layer1": (w[0], w[1]), "layer2": (w[2], w[3])}
    return tuple(w) if kind == "tuple" else list(w)


@pytest.mark.parametrize("kind", ["dict", "tuple", "list", "nested"])
def test_adjoint_of_a_field_over_a_pytree_of_weights_matches_jax(kind):
    """``lambda s, z: mlp(params, z)`` with params a container of weights,
    the JAX package's pytree style: the per-lane backsolve passes each lane
    every weight, as the JAX package's ``_per_sample_adjoint`` does."""
    x, _, z0 = _problem(batch_shape=(3,), length=6, spread=0.3)
    rng = np.random.default_rng(9)
    w = [rng.standard_normal((H, 8)) * 0.4, rng.standard_normal(8) * 0.2,
         rng.standard_normal((8, H * C)) * 0.3, rng.standard_normal(H * C) * 0.2]
    proj = rng.standard_normal((3, H))

    def loss(lib, x_, z0_, params):
        X = lib.CubicSpline(lib.hermite_cubic_coefficients_with_backward_differences(x_))
        out = lib.cdeint(X, lambda s, z: _apply(jnp if lib is tc else torch, params, z), z0_,
                         X.interval, adjoint=True, method="bosh3", options=dict(per_sample=True))
        return (out[..., -1, :] * (jnp.asarray(proj) if lib is tc else torch.from_numpy(proj))
                ).sum() + (jnp if lib is tc else torch).sin(out).sum()

    expected = jax.grad(lambda x_, z0_, w_: loss(tc, x_, z0_, _pytree(kind, w_)),
                        argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(z0),
                                           [jnp.asarray(v) for v in w])
    leaves = [v.requires_grad_() for v in _torch(x, z0, *w)]
    loss(tt, leaves[0], leaves[1], _pytree(kind, leaves[2:])).backward()
    for name, leaf, want in zip(("x", "z0", "w1", "b1", "w2", "b2"), leaves,
                                list(expected[:2]) + list(expected[2])):
        _close(leaf.grad, want, 1e-8, name)


GLOBAL_W = None  # the field of the "global" case reads it


class _Held:
    """A callable object (not a module) holding its tensor."""

    def __init__(self, W):
        self.W = W

    def __call__(self, s, z):
        return torch.tanh(z)[..., None] * self.W


def _global_field(s, z):
    return torch.tanh(z)[..., None] * GLOBAL_W


@pytest.mark.parametrize("where", ["global", "object attribute", "derived cell"])
def test_adjoint_reaches_each_tensor_the_field_reads(where):
    """The backsolve passes each lane the field's tensor wherever the field
    holds it: the gradients equal those of the same tensor in a closure."""
    global GLOBAL_W
    x, W, z0 = _problem(batch_shape=(2,), length=5, spread=0.3)
    x, W, z0 = _torch(x, W, z0)
    X = tt.CubicSpline(tt.hermite_cubic_coefficients_with_backward_differences(x))

    def grad(field, leaf):
        out = tt.cdeint(X, field, z0, X.interval, adjoint=True, method="bosh3",
                        options=dict(per_sample=True))
        return torch.autograd.grad(out[..., -1, :].square().sum(), leaf)[0]

    W1 = W.clone().requires_grad_()
    expected = grad(_field("torch", W1), W1)
    W2 = W.clone().requires_grad_()
    if where == "global":
        GLOBAL_W = W2
        got = grad(_global_field, W2)
        GLOBAL_W = None
    elif where == "object attribute":
        got = grad(_Held(W2), W2)
    else:
        half = (0.5 * W).requires_grad_()
        got = grad(_field("torch", 2.0 * half), half) / 2.0
    torch.testing.assert_close(got, expected, rtol=1e-12, atol=1e-14)


def test_one_read_per_iteration_and_one_field_call_per_stage():
    x, W, z0 = _problem(batch_shape=(5,), length=8, spread=0.6)
    calls = []

    def field(s, z):
        calls.append(None)
        return torch.tanh(z)[..., None] * W

    x, W, z0 = _torch(x, W, z0)
    X = tt.CubicSpline(tt.hermite_cubic_coefficients_with_backward_differences(x))
    per_sample.reset_counts()
    out, stats = tt.cdeint(X, field, z0, X.interval, adjoint=False, return_stats=True,
                           options=dict(per_sample=True))
    steps = int(stats["steps_attempted"].max())
    assert per_sample.HOST_READS == per_sample.ITERATIONS == steps
    # One probe of the whole batch, the first stage and the initial-step
    # evaluation, then six stages an iteration: not one call per lane-step.
    assert len(calls) == 3 + 6 * steps
    assert len(calls) < int(stats["nfe"].sum())


@pytest.mark.parametrize("method", ["dopri5", "dopri8"])
def test_a_lane_solved_alone_gives_the_same_bits(method):
    # Rough controls (random knots), where one ulp of a step size moves the
    # mesh: each lane alone must reproduce its lane of the batch exactly.
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((4, 8, C)))
    W = torch.from_numpy(rng.standard_normal((H, C)) * 0.5)
    z0 = torch.from_numpy(rng.standard_normal((4, H)))
    X = tt.CubicSpline(tt.hermite_cubic_coefficients_with_backward_differences(x))
    f = _field("torch", W)
    kw = dict(adjoint=False, method=method, return_stats=True, options=dict(per_sample=True))
    out, stats = tt.cdeint(X, f, z0, X.interval, **kw)
    for i in range(4):
        Xi = tt.CubicSpline(tt.hermite_cubic_coefficients_with_backward_differences(x[i:i + 1]))
        one, one_stats = tt.cdeint(Xi, f, z0[i:i + 1], Xi.interval, **kw)
        assert torch.equal(one[0], out[i])
        for name, value in one_stats.items():
            assert int(value[0]) == int(stats[name][i]), name


@pytest.mark.parametrize("adjoint", [False, True])
def test_lanes_padded_with_copies_give_the_same_solve(adjoint, monkeypatch):
    # On the card a small batch runs beside copies of its first lane (for
    # cuBLAS's sake): the copies change no value, statistic or gradient.
    x, W, z0 = _problem(batch_shape=(3,), length=6, spread=0.3)
    t = _rows(3, 6)

    def solve():
        leaves = [v.requires_grad_() for v in _torch(x, W, z0, t)]
        X = tt.CubicSpline(tt.hermite_cubic_coefficients_with_backward_differences(leaves[0]))
        kw = dict(return_stats=True) if not adjoint else {}
        out = tt.cdeint(X, _field("torch", leaves[1]), leaves[2], leaves[3], adjoint=adjoint,
                        method="bosh3", options=dict(per_sample=True), **kw)
        out, stats = out if not adjoint else (out, {})
        torch.sin(out).sum().backward()
        return [out] + [v.grad for v in leaves] + list(stats.values())

    expected = solve()
    monkeypatch.setattr(per_sample, "_MIN_LANES", {"cpu": 8})
    for got, want in zip(solve(), expected):
        assert torch.equal(got, want)


@pytest.mark.parametrize("adjoint", [False, True])
def test_a_bfloat16_state_plans_its_steps_in_float32(adjoint):
    # Times, knots and step sizes in float32, the state and its products in
    # bfloat16: within bfloat16's error of the float64 solve, on knots past
    # 1000, where bfloat16 cannot tell one knot from the next.
    _, W, z0 = _problem(batch_shape=(3,), length=6, spread=0.3)
    x = np.random.default_rng(8).standard_normal((3, 6, C))  # knots apart
    x, W, z0 = _torch(x, W, z0)
    t = np.linspace(1000.0, 1005.0, 6)
    kw = dict(adjoint=adjoint, method="bosh3", options=dict(per_sample=True))
    X = tt.CubicSpline(tt.hermite_cubic_coefficients_with_backward_differences(x), t=t)
    ref = tt.cdeint(X, _field("torch", W), z0, X.interval, **kw).detach()
    X16 = tt.CubicSpline(tt.hermite_cubic_coefficients_with_backward_differences(
        x, t=t).bfloat16(), t=t.astype(np.float32))
    z16 = z0.bfloat16().requires_grad_()
    out = tt.cdeint(X16, _field("torch", W.bfloat16()), z16, X16.interval, **kw)
    assert out.dtype == torch.bfloat16
    assert float((out.detach().double() - ref).abs().max()) < 0.05 * float(ref.abs().max())
    out.float().square().sum().backward()
    assert z16.grad.dtype == torch.bfloat16 and torch.isfinite(z16.grad).all()


def test_a_field_that_vmap_cannot_take_raises():
    x, W, z0 = _problem(batch_shape=(B,), length=6, spread=0.3)

    def branching(tanh, to_float):
        def field(s, z):
            scale = 2.0 if to_float(z.sum()) > 0 else 1.0  # data-dependent Python control
            return tanh(z)[..., None] * W * scale
        return field

    X = tc.CubicSpline(tc.hermite_cubic_coefficients_with_backward_differences(jnp.asarray(x)))
    with pytest.raises(Exception):
        tc.cdeint(X, branching(jnp.tanh, float), jnp.asarray(z0), X.interval, adjoint=False,
                  method="bosh3", options=dict(per_sample=True))
    x, W, z0 = _torch(x, W, z0)
    X = tt.CubicSpline(tt.hermite_cubic_coefficients_with_backward_differences(x))
    with pytest.raises(RuntimeError, match="vmap"):
        tt.cdeint(X, branching(torch.tanh, float), z0, X.interval, adjoint=False,
                  method="bosh3", options=dict(per_sample=True))
