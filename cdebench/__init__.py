"""cdebench: the benchmark of torchcde_tpu_torch, the PyTorch and CUDA port.

One command runs one cell once (``python3 cdebench/run.py --workload <name>
--seed <n> --seconds <s> --trace <0|1>``); ``README.md`` says how cells,
configurations, traffic mixes and metrics are added as files.  The harness
imports the port and never the JAX package.
"""
