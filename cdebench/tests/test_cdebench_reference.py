"""The plain reference against the port's CPU path, in float64 at a tiny size:
the same train steps give the same logits, losses, gradients and Adam steps."""

import json

import pytest
import torch

from cdebench import program
from cdebench.reference import model as reference

# Relative tolerances of two float64 solves.  Where a dopri5 step ends just
# past a spline knot the error estimate magnifies rounding and two meshes
# part, so the one-step test feeds paths linear in time (no knots), as the
# repository's adaptive parity tests do; rk4 runs the spirals too.
CONFIGS = {"spiral-rk4-h8": 1e-10, "spiral-dopri5-adjoint-h8": 1e-9}


def port_record(config, weights, batches):
    from torchcde_tpu_torch.models import NeuralCDE, NeuralCDEConfig, make_train_step

    model = NeuralCDE(NeuralCDEConfig(**config["model"]), device="cpu", dtype=torch.float64)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name].to(torch.float64))
    opt = config["optimizer"]
    optimizer = torch.optim.Adam(model.parameters(), lr=opt["lr"], betas=tuple(opt["betas"]),
                                 eps=opt["eps"])
    step = make_train_step(model, optimizer)
    logits = []
    hook = model.register_forward_hook(lambda m, i, out: logits.append(out.detach()[..., 0]))
    losses, grad1 = [], None
    for x, labels in batches:
        coeffs = program.coefficients(x.to(torch.float64))
        losses.append(float(step(coeffs, labels.to(torch.float64))))
        if grad1 is None:
            grad1 = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    hook.remove()
    change = {n: p.detach() - weights[n].to(torch.float64) for n, p in model.named_parameters()}
    return {"losses": losses, "grad1": grad1, "change": change, "logits1": logits[0]}


def linear_paths(steps, batch, length, gen):
    """Paths linear in time: the time channel and two random slopes."""
    t = torch.linspace(0, 1, length, dtype=torch.float64)
    slope = torch.rand((steps, batch, 1, 2), generator=gen, dtype=torch.float64) - 0.5
    start = torch.rand((steps, batch, 1, 2), generator=gen, dtype=torch.float64)
    x = torch.cat([t.expand(steps, batch, length)[..., None], start + slope * t[:, None]], -1)
    labels = (torch.rand((steps, batch), generator=gen) > 0.5).to(torch.float64)
    return x.to(torch.float32), labels


def setup(root, name, steps, linear=False):
    config = json.loads((root / "cdebench" / "configs" / f"{name}.json").read_text())
    gen = program.generator(2**31 + 99, "cpu")
    weights = program.initial_weights(config["model"], gen, "cpu")
    if linear:
        x, labels = linear_paths(steps, 48, 12, gen)
    else:
        x, labels = program.data({"pool": steps, "batch": 48, "length": 12}, gen, "cpu")
    batches = [(x[k], labels[k]) for k in range(steps)]
    port = port_record(config, weights, batches)
    ref = reference.train_record(weights, batches, config["model"], config["solver_semantics"],
                                 config["optimizer"], reference.Precision("float64"))
    return config, weights, port, ref


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_train_step_matches_port(root, name):
    """One step: logits, loss, every gradient, and Adam's update of the
    port's gradient."""
    config, weights, port, ref = setup(root, name, 1, linear=True)
    tol = CONFIGS[name]
    torch.testing.assert_close(port["logits1"], ref["logits1"], rtol=tol, atol=tol)
    assert abs(port["losses"][0] - ref["losses"][0]) <= tol * abs(ref["losses"][0])
    for leaf in reference.LEAVES:
        scale = float(ref["grad1"][leaf].abs().max())
        torch.testing.assert_close(port["grad1"][leaf], ref["grad1"][leaf], rtol=10 * tol,
                                   atol=10 * tol * scale)
    params = {k: v.to(torch.float64).clone() for k, v in weights.items()}
    opt = config["optimizer"]
    adam = reference.Adam(params, opt["lr"], tuple(opt["betas"]), opt["eps"])
    adam.step(params, port["grad1"])
    for leaf in reference.LEAVES:
        torch.testing.assert_close(params[leaf] - weights[leaf].to(torch.float64),
                                   port["change"][leaf], rtol=1e-10, atol=1e-15)


def test_reference_three_rk4_steps_match_port(root):
    """Three rk4 steps (no mesh to part): the losses and the change."""
    _, _, port, ref = setup(root, "spiral-rk4-h8", 3)
    for p, r in zip(port["losses"], ref["losses"]):
        assert abs(p - r) <= 1e-12 * abs(r)
    for leaf in reference.LEAVES:
        torch.testing.assert_close(port["change"][leaf], ref["change"][leaf], rtol=1e-9, atol=1e-13)


def test_hermite_reproduces_knots_and_slopes():
    x = torch.randn(2, 7, 3, dtype=torch.float64)
    a, b, c, d = reference.hermite(x)
    torch.testing.assert_close(a + b + c + d, x[:, 1:])  # p(1) is the next knot
    torch.testing.assert_close(b[:, 1:], x[:, 1:-1] - x[:, :-2])  # backward differences
    torch.testing.assert_close(b + 2 * c + 3 * d, x[:, 1:] - x[:, :-1])  # C1 at each knot


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -(1.0 + 2**-12)])
    out = reference.to_tf32(x)
    assert out.tolist() == [1.0 + 2**-10, 1.0, 1.0 + 2**-9, -1.0]


def test_seeds_permute_one_function(root):
    """Two seeds' weights differ in place but compute the same logits."""
    config = json.loads((root / "cdebench" / "configs" / "spiral-rk4-h8.json").read_text())
    a = program.initial_weights(config["model"], program.generator(1, "cpu"), "cpu")
    b = program.initial_weights(config["model"], program.generator(2, "cpu"), "cpu")
    assert not torch.equal(a["func.linear1.weight"], b["func.linear1.weight"])
    x, _ = program.data({"pool": 1, "batch": 16, "length": 12}, program.generator(3, "cpu"), "cpu")
    run = [reference.logits_of(w, x[0], config["model"], config["solver_semantics"],
                               reference.Precision("float64"))[0] for w in (a, b)]
    torch.testing.assert_close(run[0], run[1], rtol=1e-12, atol=1e-12)
