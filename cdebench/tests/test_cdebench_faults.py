"""``correct`` catches a broken timed path, and the control fails.

The harness's run (without its look for a card) on the CPU, where the port
runs its plain versions, at small sizes: with each fault of ``faults.py``
planted underneath, the number that the fault must fail exceeds its limit
and the run comes out not correct; sound, an rk4 cell comes out correct
(dopri5's sound runs need the cells' own batch for ``lane_noise``, which the
card's runs show).  The control, the reference in TF32 in the program's
place, fails the cell's limits.
"""

import time

import pytest
import torch

from cdebench import compare, faults, harness

SIZES = {
    "rk4-train-b16384": {"batch": 256, "length": 40},
    "rk4-infer-b65536": {"batch": 512, "length": 40},
    "dopri5-train-b4096": {"batch": 512, "length": 30},
    "dopri5-infer-b16384": {"batch": 512, "length": 30},
}
# The number each fault has to fail, by cell.
CAUGHT_BY = {
    ("rk4-train-b16384", "frozen"): "change_norm_gap",
    ("rk4-train-b16384", "half"): "grad_norm_gap",
    ("rk4-train-b16384", "answer"): "logit_gap",
    ("rk4-infer-b65536", "frozen"): "logit_gap",
    ("rk4-infer-b65536", "answer"): "logit_gap",
    ("dopri5-train-b4096", "frozen"): "change_norm_gap",
    ("dopri5-train-b4096", "half"): "loss_consistency",
    ("dopri5-train-b4096", "answer"): "logit_gap",
    ("dopri5-infer-b16384", "frozen"): "logit_gap",
    ("dopri5-infer-b16384", "answer"): "logit_gap",
}


def run(root, cell):
    result, lines = harness.run_cell(cell, 2**31 + 11, 0.05, 0, torch.device("cpu"), root,
                                     time.perf_counter(), traffic=SIZES[cell])
    return result["correct"], {name: (value, limit) for name, value, limit in lines}


@pytest.mark.parametrize("cell,fault", sorted(CAUGHT_BY))
def test_fault_makes_the_run_incorrect(root, cell, fault):
    with faults.planted(fault, "train" if "train" in cell else "infer"):
        correct, checks = run(root, cell)
    value, limit = checks[CAUGHT_BY[cell, fault]]
    assert value > limit, checks
    assert not correct


@pytest.mark.parametrize("cell", ["rk4-train-b16384", "rk4-infer-b65536"])
def test_sound_run_is_correct(root, cell):
    correct, checks = run(root, cell)
    assert correct, checks


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_control_fails_the_limits(root, cell):
    spec = harness.load_cell(cell, root)
    spec["traffic"].update(SIZES[cell])
    session = harness.session_for(spec, 2**31 + 13, torch.device("cpu"))
    session.setup_inputs()
    if spec["traffic"]["mode"] == "train":
        readings = compare.train_readings(session.reference_record("tf32"),
                                          session.reference_record(), session.x[0],
                                          session.labels[0], session.blocks())
    else:
        k = session.sample_batches()[0]
        control, ref = session.reference_logits(k, "tf32"), session.reference_logits(k)
        readings = {"logit_gap": compare.logit_gap(control, ref),
                    "lane_noise": compare.lane_noise(control, ref, session.x[k],
                                                     session.blocks())}
    correct, lines = compare.verdict(readings, spec["limits"])
    assert not correct, lines
