"""The harness's run on the CPU at a tiny size, its result line, and its
refusals: no card, JAX loaded, a checkout without the port."""

import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from cdebench import harness, readers, trace

TINY = {"batch": 64, "length": 12}


def test_no_card_fails_loudly(root):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible here")
    proc = subprocess.run([sys.executable, "cdebench/run.py", "--workload", "rk4-infer-b65536",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=root, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_checkout_without_the_port_fails(root, tmp_path):
    (tmp_path / "cdebench").mkdir()
    shutil.copy(root / "BENCHMARK.json", tmp_path)
    shutil.copytree(root / "cdebench", tmp_path / "cdebench", dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "cdebench/run.py", "--workload", "rk4-infer-b65536",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_forbidden_modules_compare_top_level_names():
    assert harness.forbidden_modules(["jax", "jax.numpy", "torchcde_tpu_torch.models"]) == ["jax"]
    assert harness.forbidden_modules(["torchcde_tpu.solvers", "jaxlib"]) == ["jaxlib",
                                                                              "torchcde_tpu"]
    assert harness.forbidden_modules(["torchcde_tpu_torch", "torchcde_tpu_torchx", "jaxx"]) == []


def test_jax_loaded_stops_the_run(root):
    with pytest.raises(harness.ForbiddenModules):
        harness.run_cell("rk4-infer-b65536", 5, 0.05, 0, torch.device("cpu"), root,
                         time.perf_counter(), modules=list(sys.modules) + ["jax.numpy"],
                         traffic=TINY)


@pytest.mark.parametrize("cell", ["rk4-train-b16384", "rk4-infer-b65536"])
def test_result_line_keys(root, cell):
    result, lines = harness.run_cell(cell, 2**31 + 7, 0.2, 0, torch.device("cpu"), root,
                                     time.perf_counter(), traffic=TINY)
    assert set(result) == {"correct", "attempted", "failed", "metrics", "device"}
    assert result["attempted"] >= 1 and result["failed"] == 0
    bench = json.loads((root / "BENCHMARK.json").read_text())
    expected = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(result["metrics"]) == expected
    line = dict(result, checks=harness.checks_line(lines))
    assert list(json.loads(json.dumps(line)))[-1] == "checks"
    assert {name for name, _, _ in lines} == set(harness.load_cell(cell, root)["limits"])


def test_union_and_idle_labels():
    device = [(0.0, 10.0, "k"), (5.0, 12.0, "k"), (20.0, 30.0, "k"), (40.0, 41.0, "k")]
    assert trace.union_us(device) == 23.0
    ops = [(11.0, 25.0, "aten::item"), (13.0, 14.0, "cudaMemcpyAsync")]
    spans = [(0.0, 35.0)]
    idle = trace.idle_by_host(device, ops, spans)
    assert idle == {"aten::item": 8e-6, "in call": 10e-6}
    assert trace.idle_by_host(device, ops, [(0.0, 25.0)])["between calls"] == 10e-6


def test_readers_on_a_synthetic_summary(root):
    summary = {"mode": "train", "calls": 2, "window_s": 0.1, "busy_s": 0.08,
               "device": [("void fwd_slice_kernel<3, 8>(float*)", 0.0, 10000.0),
                          ("void bwd_slice_kernel<3, 8>(float*)", 10000.0, 40000.0),
                          ("Memcpy HtoD", 40000.0, 41000.0)],
               "spans_s": [0.001, 0.003, 0.002],
               "work": {"model_flops_fwd": 1e9,
                        "kernels": {"K1": {"fwd_s": 0.001, "bwd_s": 0.003,
                                           "names": ["fwd_slice_kernel", "bwd_slice_kernel"]}}}}
    read = {m: harness.reader(m)(summary) for m in
            ("k1_roofline.train", "k2_roofline.train", "k1_roofline.infer", "step_mfu_pct.train",
             "device_idle_pct.train", "other_device_ms.train", "device_ops_per_step.train",
             "host_call_ms.train", "host_call_ms.infer", "adaptive.device_idle_pct.train")}
    assert read["k1_roofline.train"] == pytest.approx(100 * 0.004 / 0.02)
    assert read["k2_roofline.train"] is None and read["k1_roofline.infer"] is None
    assert read["step_mfu_pct.train"] == pytest.approx(100 * 3 * 1e9 * 2 / 0.1 / 67e12)
    assert read["device_idle_pct.train"] == pytest.approx(20.0)
    assert read["adaptive.device_idle_pct.train"] == read["device_idle_pct.train"]
    assert read["other_device_ms.train"] == pytest.approx(0.5)
    assert read["device_ops_per_step.train"] == 1.5
    assert read["host_call_ms.train"] == pytest.approx(2.0)
    assert read["host_call_ms.infer"] is None


def test_readers_find_a_kernel_by_the_names_its_work_gives():
    summary = {"mode": "infer", "calls": 1, "window_s": 0.1, "busy_s": 0.05,
               "device": [("void rev_fwd_kernel<3, 1>(float*)", 0.0, 20000.0),
                          ("Memcpy HtoD", 20000.0, 21000.0)],
               "spans_s": [0.02],
               "work": {"model_flops_fwd": 1e9,
                        "kernels": {"K8": {"fwd_s": 0.001, "bwd_s": 0.0,
                                           "names": ["rev_fwd_kernel"]}}}}
    assert readers.roofline(summary, "K8", "infer") == pytest.approx(100 * 0.001 / 0.02)
    assert readers.other_device_ms(summary, "infer") == pytest.approx(1.0)


def test_a_family_metric_reads_its_base():
    values = {"train_samples_per_s": 1.0, "setup_s": 2.0}
    assert harness.base_name("adaptive.train_samples_per_s", values.__contains__) == \
        "train_samples_per_s"
    assert harness.base_name("setup_s", values.__contains__) == "setup_s"
