"""Faults planted in the program's timed path, to show that ``correct``
catches them (``tests/test_cdebench_faults.py``, ``control.py``):

* ``frozen``: a step that returns its state unchanged: in training the
  optimizer's update is undone; in inference each solve returns its
  initial state;
* ``half``: half of the batch left out of the loss, the mean taken over the
  rest (training);
* ``answer``: one row's logit altered where the model produces it.
"""

import contextlib

import torch

FAULTS = {"train": ("frozen", "half", "answer"), "infer": ("frozen", "answer")}


@contextlib.contextmanager
def planted(name, mode):
    from torchcde_tpu_torch.models import neural_cde, training

    saved = []

    def patch(owner, attr, value):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    if name == "frozen" and mode == "train":
        step = torch.optim.Adam.step

        def unchanged(self, *args, **kwargs):
            before = [p.detach().clone() for g in self.param_groups for p in g["params"]]
            out = step(self, *args, **kwargs)
            with torch.no_grad():
                for p, b in zip((p for g in self.param_groups for p in g["params"]), before):
                    p.copy_(b)
            return out

        patch(torch.optim.Adam, "step", unchanged)
    elif name == "frozen":
        def initial_state(X, func, z0, t, **kwargs):
            return z0[..., None, :].expand(z0.shape[:-1] + (len(t), z0.shape[-1]))

        patch(neural_cde, "cdeint", initial_state)
    elif name == "half":
        def half_loss(model, coeffs, labels):
            logits = model(coeffs)[..., 0]
            keep = logits.shape[0] // 2
            return neural_cde.bce_with_logits(logits[:keep], labels[:keep].to(logits.dtype))

        patch(training, "loss_fn", half_loss)
    elif name == "answer":
        forward = neural_cde.NeuralCDE.forward

        def altered(self, *args, **kwargs):
            out = forward(self, *args, **kwargs)
            return out + torch.nn.functional.one_hot(
                torch.zeros((), dtype=torch.long, device=out.device), out.shape[0]
            ).to(out.dtype)[:, None]

        patch(neural_cde.NeuralCDE, "forward", altered)
    else:
        raise ValueError(f"no fault {name!r} for mode {mode!r}")
    try:
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)
