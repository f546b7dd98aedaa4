"""One run of one benchmark cell on the CUDA card(s) of this machine.

    python3 cdebench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints one JSON object as the last line of
standard output (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, ``breakdown`` when traced, and ``checks``: the numbers compared
with their limits), and the same numbers as the last lines of standard
error.  Exits non-zero, printing no result, without enough CUDA cards, when
JAX or the JAX package is loaded, or when the port is missing.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from cdebench import harness

    cell = harness.load_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"cdebench: the cell needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()} and "
              f"{torch.cuda.device_count()} are visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        result, lines = harness.run_cell(args.workload, args.seed, args.seconds, args.trace,
                                         torch.device("cuda", 0), ROOT, PROCESS_START)
    except harness.ForbiddenModules as err:
        print(f"cdebench: {err}", file=sys.stderr)
        return 3
    result["checks"] = harness.checks_line(lines)
    for name, value, limit in lines:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
