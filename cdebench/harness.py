"""Runs one cell once: set-up, the measured window, the check, the result.

Everything that belongs to one cell is found by name: the cell's entry in
``BENCHMARK.json`` names its configuration (``configs/``) and traffic
(``traffic/<traffic>.json``); the traffic names its mode
(``modes/<mode>.py``); the configuration's solver names its work
(``work/<solver>.py``) and its reference (``reference/<solver>.py``); each
per-layer metric is read by ``metrics/<name>.py``; the cell's limits are
``workloads/<cell>.json``.

A metric named ``<family>.<name>`` (``adaptive.train_samples_per_s``) is
``<name>`` in the cells that its entry lists: it gives a family of cells
whose runs spread more than the others' a bound of its own, and needs no
file of its own.
"""

import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
# Top-level module names that may not be loaded: JAX and the JAX package
# (the port, torchcde_tpu_torch, is another name and is allowed).
FORBIDDEN = ("jax", "jaxlib", "flax", "torchcde_tpu")


def forbidden_modules(modules=None):
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def check_modules(modules=None):
    found = forbidden_modules(modules)
    if found:
        raise ForbiddenModules(found)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(name, root):
    bench = load_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])

    def applies(metric):
        return "workloads" not in metric or name in metric["workloads"]

    end_to_end = [m for m in bench["end_to_end"] if applies(m)]
    reported = {m["name"] for m in end_to_end}

    def layer_applies(metric):
        if "workloads" in metric:
            return name in metric["workloads"]
        return metric["moves"] in reported

    per_layer = [m for m in bench["per_layer"] if layer_applies(m)]
    return {"name": name, "chips": entry["chips"],
            "config": load_json(root / config_entry["file"]),
            "traffic": load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
            "limits": load_json(HERE / "workloads" / f"{name}.json")["limits"],
            "end_to_end": end_to_end, "per_layer": per_layer}


def base_name(name, known):
    """The name that a metric reads: ``name`` itself if ``known(name)``, else
    the name after its family, ``<family>.``, stripped until one is known."""
    while not known(name) and "." in name:
        name = name.split(".", 1)[1]
    return name


def reader(metric_name):
    metric_name = base_name(metric_name, lambda n: (HERE / "metrics" / f"{n}.py").exists())
    path = HERE / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(
        "cdebench_metric_" + metric_name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def session_for(cell, seed, device):
    mode = importlib.import_module(f"cdebench.modes.{cell['traffic']['mode']}")
    return mode.Session(cell, seed, device)


def synchronize(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_window(session, seconds, tracer, device):
    """Calls the entry until the deadline; the window ends when the device has
    finished the last call issued before it.  A CUDA event after each call
    (no sync) gives each call's period on the device."""
    import torch

    if device.type == "cuda":
        def mark():
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event

        def elapsed_ms(a, b):
            return a.elapsed_time(b)
    else:
        mark = time.perf_counter

        def elapsed_ms(a, b):
            return (b - a) * 1e3

    synchronize(device)
    marks = [mark()]
    start = time.perf_counter()
    deadline = start + seconds
    while True:
        with tracer.span():
            session.call()
        marks.append(mark())
        if time.perf_counter() >= deadline:
            break
    synchronize(device)
    seconds = time.perf_counter() - start
    gaps = [elapsed_ms(a, b) for a, b in zip(marks, marks[1:])]
    return {"calls": len(gaps), "seconds": seconds, "gaps_ms": gaps}


def device_info(device, chips):
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def top(pairs, n=10):
    return [[name, seconds] for name, seconds in sorted(pairs, key=lambda p: -p[1])[:n]]


def run_cell(name, seed, seconds, trace, device, root, process_start, modules=None,
             traffic=None):
    """One run of the cell.  Returns (result, check lines); ``result`` is the
    last line's object without its "checks" key.  ``modules``: the names the
    JAX check reads (``sys.modules``); ``traffic``: keys that replace the
    traffic's (the CPU tests run tiny batches)."""
    import torch

    from cdebench import compare
    from cdebench.trace import Tracer

    cell = load_cell(name, root)
    cell["traffic"].update(traffic or {})
    session = session_for(cell, seed, device)
    entered = time.perf_counter()
    session.setup()
    synchronize(device)
    check_modules(modules)
    setup_s = time.perf_counter() - process_start
    print(f"cdebench: setup_s {setup_s:.3f}: {entered - process_start:.3f} to the session "
          f"(imports, the CUDA context), {setup_s - entered + process_start:.3f} in its "
          "set-up (the library, inputs, model, warm-up)", file=sys.stderr)

    with Tracer(bool(trace)) as tracer:
        window = run_window(session, seconds, tracer, device)
    info = device_info(device, cell["chips"])
    check_modules(modules)
    failed = session.failed()

    summary = None
    if trace:
        summary = tracer.summary()
        info["busy_s"] = summary["busy_s"]
        info["window_s"] = window["seconds"]
    session.free()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    readings = session.readings()
    correct, lines = compare.verdict(readings, cell["limits"])
    correct = correct and failed == 0

    if trace:
        model = cell["config"]["model"]
        work_module = importlib.import_module(f"cdebench.work.{model['solver']}")
        summary.update({"mode": cell["traffic"]["mode"], "calls": window["calls"],
                        "window_s": window["seconds"], "batch": cell["traffic"]["batch"],
                        "work": work_module.work(model, cell["traffic"]["batch"],
                                                 cell["traffic"]["length"],
                                                 session.work_counts())})
        metrics = {}
        for metric in cell["per_layer"]:
            value = reader(metric["name"])(summary)
            if value is not None:
                metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
        by_name = {}
        for op, s, e in summary["device"]:
            by_name[op] = by_name.get(op, 0.0) + (e - s) / 1e6
        breakdown = {"device_ops": top(by_name.items()),
                     "idle_gaps": top(summary["idle"].items())}
    else:
        values = session.end_to_end(window)
        values["setup_s"] = setup_s
        metrics = {m["name"]: {"value": values[base_name(m["name"], values.__contains__)],
                               "unit": m["unit"]}
                   for m in cell["end_to_end"]}
        breakdown = None

    check_modules(modules)
    result = {"correct": bool(correct), "attempted": window["calls"], "failed": failed,
              "metrics": metrics, "device": info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    return result, lines


class ForbiddenModules(RuntimeError):
    def __init__(self, names):
        super().__init__("modules of JAX or the JAX package are loaded: " + ", ".join(names))
        self.names = names


def checks_line(lines):
    """The numbers compared, each with its limit, for the result's last key."""
    return {name: {"value": value, "limit": limit} for name, value, limit in lines}
