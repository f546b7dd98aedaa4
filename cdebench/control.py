"""The readings that the cells' limits are set from (``PERF.md``).

    python3 cdebench/control.py --workload <name> --seeds 1,2,3 \
        --what program,control,half,answer [--out FILE]

For each seed, in one process: the float64 reference once; then each of
``what``: ``program``, the program as the benchmark runs it (training: set-up
with its first three steps; inference: set-up and one call per pool batch,
the calls sampled as a run samples them); ``control``, the reference in
float32 with its matrix products' operands rounded to TF32, in the
program's place; or a fault of ``faults.py`` planted in the program.  Prints
one JSON line per seed and reading.  The benchmark's own runs never run
this.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings_for(cell, seed, what, device, ref_cache):
    import torch

    from cdebench import compare, faults, harness

    session = harness.session_for(cell, seed, device)
    mode = cell["traffic"]["mode"]
    if what == "control":
        session.setup_inputs()
        if mode == "train":
            record = session.reference_record("tf32")
            ref = ref_cache.setdefault("train", session.reference_record())
            return compare.train_readings(record, ref, session.x[0], session.labels[0],
                                          session.blocks())
        out = {}
        for k in session.sample_batches():
            logits = session.reference_logits(k, "tf32")
            ref = ref_cache.setdefault(k, session.reference_logits(k))
            gap = compare.logit_gap(logits, ref)
            noise = compare.lane_noise(logits, ref, session.x[k], session.blocks())
            out = {"logit_gap": max(gap, out.get("logit_gap", 0.0)),
                   "lane_noise": max(noise, out.get("lane_noise", 0.0))}
        return out
    with faults.planted(what, mode) if what != "program" else contextlib.nullcontext():
        session.setup()
        if mode == "infer":
            for _ in range(session.pool):
                session.call()
        harness.synchronize(device)
    session.free()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if mode == "train":
        if "train" not in ref_cache:
            ref_cache["train"] = session.reference_record()
        return session.readings(ref_cache["train"])
    return session.readings(ref_cache)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--what", default="program")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from cdebench import harness

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    cell = harness.load_cell(args.workload, ROOT)
    sink = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        ref_cache = {}
        for what in args.what.split(","):
            start = time.perf_counter()
            values = readings_for(cell, seed, what, device, ref_cache)
            line = json.dumps({"workload": args.workload, "seed": seed, "what": what,
                               "readings": values, "seconds": time.perf_counter() - start})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
