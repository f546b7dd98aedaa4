"""The port stands without JAX, and its chip check refuses to run without a card."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _run(args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import torchcde_tpu_torch, torchcde_tpu_torch.models, torchcde_tpu_torch.interop\n"
        "import torchcde_tpu_torch.solvers.fused_fixed_kernel, torchcde_tpu_torch._build\n"
        "import torchcde_tpu_torch.misc, torchcde_tpu_torch.ops.dispatch\n"
        "import torchcde_tpu_torch.ops.fill_kernel, torchcde_tpu_torch.ops.tridiagonal_kernel\n"
        "import torchcde_tpu_torch.ops.masked_tridiagonal_kernel\n"
        "import torchcde_tpu_torch.ops.masked_cubic_kernel\n"
        "import torchcde_tpu_torch.log_ode, torchcde_tpu_torch.ops.logsignature\n"
        "import torchcde_tpu_torch.interpolation.linear\n"
        "import torchcde_tpu_torch.solvers.reversible_adjoint\n"
        "import torchcde_tpu_torch.solvers.fused_reversible_kernel\n"
        "import torchcde_tpu_torch.solvers.fused_dopri_persample\n"
        "import torchcde_tpu_torch.solvers.fused_dopri_persample_kernel\n"
        "import torchcde_tpu_torch.utils.tuple_control, torchcde_tpu_torch.solvers.runge_kutta\n"
        "import torchcde_tpu_torch.solvers.integrate, torchcde_tpu_torch.solvers.adjoint\n"
        "import torchcde_tpu_torch.data, torchcde_tpu_torch.native\n"
        "import torchcde_tpu_torch.utils.observability\n"
        "import torchcde_tpu_torch.parallel, torchcde_tpu_torch.parallel.comm\n"
        "import torchcde_tpu_torch.parallel.launch, torchcde_tpu_torch.parallel.seq_masked\n"
        "sys.path.insert(0, 'examples')\n"
        "import torch_time_series_classification, torch_logsignature_example\n"
        "import torch_irregular_data, torch_parallel_training\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'orbax', 'torchcde_tpu'))\n"
        "assert not bad, bad\n"
    )
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr


EXAMPLES = ("torch_time_series_classification.py", "torch_logsignature_example.py",
            "torch_irregular_data.py", "torch_parallel_training.py")


def test_port_sources_name_no_jax():
    paths = list((ROOT / "torchcde_tpu_torch").rglob("*.py"))
    paths += [ROOT / "examples" / name for name in EXAMPLES]
    for path in paths:
        for line in path.read_text().splitlines():
            stripped = line.strip()
            assert not stripped.startswith(("import jax", "from jax", "import optax",
                                            "from optax", "import orbax", "from orbax")), (
                path, line)
            assert not stripped.startswith(("import torchcde_tpu ", "from torchcde_tpu.",
                                            "from torchcde_tpu ")), (path, line)


def test_chip_smoke_fails_without_a_card():
    # This box has no CUDA device: the script must exit non-zero at its first
    # phase, before building any kernel, and print no result line.
    proc = _run(["chip_smoke.py"])
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    assert '"ok"' not in proc.stdout
    assert "build:" not in proc.stdout
