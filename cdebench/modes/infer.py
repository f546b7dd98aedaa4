"""Inference: the port's forward pass under ``torch.no_grad()`` on the pool's
batches, one after another, as a held-out set or an archive is scored.

Every call's logits are kept; once the window has closed, a sample of the
calls drawn from the seed (``sample_calls`` of the traffic) is held against
the reference's logits of the same raw spirals and initial weights.
"""

import random

import torch

from cdebench import compare, program
from cdebench.reference import model as reference

WARM_CALLS = 2


class Session:
    def __init__(self, cell, seed, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.config, self.traffic = cell["config"], cell["traffic"]
        self.batch, self.pool = self.traffic["batch"], self.traffic["pool"]
        self.outputs = []
        self.counts = []

    def setup_inputs(self):
        """The initial weights and the raw pool, from the seed."""
        gen = program.generator(self.seed, self.device)
        self.weights0 = program.initial_weights(self.config["model"], gen, self.device)
        self.x, self.labels = program.data(self.traffic, gen, self.device)

    def setup(self):
        self.setup_inputs()
        self.coeffs = program.coefficients(self.x)
        self.model = program.build_model(self.config, self.weights0, self.device)
        for k in range(WARM_CALLS):
            with torch.no_grad():
                self.model(self.coeffs[k % self.pool])
        self.next = WARM_CALLS

    def call(self):
        k = self.next % self.pool
        self.next += 1
        with torch.no_grad():
            self.outputs.append((k, self.model(self.coeffs[k])[..., 0]))

    def end_to_end(self, window):
        return {"infer_samples_per_s": window["calls"] * self.batch / window["seconds"]}

    def failed(self):
        if not self.outputs:
            return 0
        finite = torch.stack([torch.isfinite(out).all() for _, out in self.outputs])
        return int((~finite).sum())

    def sample(self, calls=None):
        """The sampled calls' indices among ``calls`` (the window's), drawn
        from the seed."""
        calls = len(self.outputs) if calls is None else calls
        n = min(self.traffic["sample_calls"], calls)
        return sorted(random.Random(self.seed).sample(range(calls), n))

    def sample_batches(self, calls=None):
        """The pool batches of the sampled calls of a window of ``calls``
        calls (one per pool batch by default)."""
        calls = self.pool if calls is None else calls
        return sorted({(WARM_CALLS + i) % self.pool for i in self.sample(calls)})

    def blocks(self):
        return reference.solver(self.config["model"]["solver"]).blocks(
            self.batch, self.config["solver_semantics"])

    def free(self):
        """Drops the program's state; keeps the sampled calls' logits."""
        self.kept = [self.outputs[i] for i in self.sample()]
        self.model = self.coeffs = None
        self.outputs = []

    def reference_logits(self, k, precision="float64"):
        logits, counts = reference.logits_of(self.weights0, self.x[k], self.config["model"],
                                             self.config["solver_semantics"],
                                             reference.Precision(precision))
        self.counts = counts
        return logits

    def work_counts(self):
        if not self.counts:
            self.reference_logits(self.kept[-1][0] if self.kept else 0)
        return self.counts

    def readings(self, refs=None):
        """The numbers compared; ``refs``: {pool batch: the float64
        reference's logits}, filled here as needed."""
        blocks = self.blocks()
        gaps, noise = [], []
        refs = {} if refs is None else refs
        for k, out in self.kept:
            if k not in refs:
                refs[k] = self.reference_logits(k)
            gaps.append(compare.logit_gap(out, refs[k]))
            noise.append(compare.lane_noise(out, refs[k], self.x[k], blocks))
        if not gaps:
            return {}
        return {"logit_gap": max(gaps), "lane_noise": max(noise)}
