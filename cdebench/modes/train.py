"""Training: the port's train step on the pool's batches, one after another.

Set-up builds the step from ``make_train_step(NeuralCDE(cfg), Adam)`` and
drives it through its first three steps on pool batches 0, 1 and 2, whose
rows all differ; the window continues with the same object from batch 3.
Those three steps are what the reference follows: each step's loss, the
first gradient as Adam holds it after one step (exp_avg / (1 - beta1)),
the parameters' change after the three, read before step 4, and the first
step's logits, as the model's forward hook sees them.
"""

import numpy as np
import torch

from cdebench import compare, program
from cdebench.reference import model as reference

FIRST_STEPS = 3


class Session:
    def __init__(self, cell, seed, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.config, self.traffic = cell["config"], cell["traffic"]
        self.batch, self.pool = self.traffic["batch"], self.traffic["pool"]
        self.losses = []

    def setup_inputs(self):
        """The initial weights and the raw pool, from the seed."""
        gen = program.generator(self.seed, self.device)
        self.weights0 = program.initial_weights(self.config["model"], gen, self.device)
        self.x, self.labels = program.data(self.traffic, gen, self.device)

    def setup(self):
        from torchcde_tpu_torch.models import make_train_step

        self.setup_inputs()
        self.coeffs = program.coefficients(self.x)
        self.model = program.build_model(self.config, self.weights0, self.device)
        opt = self.config["optimizer"]
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=opt["lr"],
                                          betas=tuple(opt["betas"]), eps=opt["eps"])
        self.step = make_train_step(self.model, self.optimizer)
        logits = []
        hook = self.model.register_forward_hook(lambda m, i, out: logits.append(out.detach()))
        losses, grad1 = [], None
        for k in range(FIRST_STEPS):
            losses.append(self.step(self.coeffs[k], self.labels[k]))
            if k == 0:
                beta1 = opt["betas"][0]
                grad1 = {name: self.optimizer.state[p]["exp_avg"].to(torch.float64) / (1 - beta1)
                         for name, p in self.model.named_parameters()}
        hook.remove()
        change = {name: p.detach().to(torch.float64) - self.weights0[name].to(torch.float64)
                  for name, p in self.model.named_parameters()}
        self.record = {"losses": [float(v) for v in losses], "grad1": grad1, "change": change,
                       "logits1": logits[0][..., 0]}
        self.next = FIRST_STEPS

    def call(self):
        k = self.next % self.pool
        self.next += 1
        self.last = k
        self.losses.append(self.step(self.coeffs[k], self.labels[k]))

    def end_to_end(self, window):
        return {"train_samples_per_s": window["calls"] * self.batch / window["seconds"],
                "train_step_ms_p95": float(np.percentile(window["gaps_ms"], 95))}

    def failed(self):
        if not self.losses:
            return 0
        return int((~torch.isfinite(torch.stack(self.losses))).sum())

    def work_counts(self):
        """The reference's solver counts on the last batch of the window at
        the parameters the window ended with (the work depends on them)."""
        _, counts = reference.logits_of(self.final_params, self.x[self.last], self.config["model"],
                                        self.config["solver_semantics"],
                                        reference.Precision("float64"))
        return counts

    def free(self):
        """Drops the program's state; keeps the raw data, the record and the
        parameters the window ended with."""
        self.final_params = {k: v.detach().clone() for k, v in self.model.named_parameters()}
        self.model = self.optimizer = self.step = self.coeffs = None
        self.losses = []

    def reference_record(self, precision="float64"):
        batches = [(self.x[k], self.labels[k]) for k in range(FIRST_STEPS)]
        return reference.train_record(self.weights0, batches, self.config["model"],
                                      self.config["solver_semantics"], self.config["optimizer"],
                                      reference.Precision(precision))

    def blocks(self):
        return reference.solver(self.config["model"]["solver"]).blocks(
            self.batch, self.config["solver_semantics"])

    def readings(self, ref=None):
        """The numbers compared; ``ref``: the float64 reference's record, if
        already made."""
        ref = self.reference_record() if ref is None else ref
        return compare.train_readings(self.record, ref, self.x[0], self.labels[0], self.blocks())
