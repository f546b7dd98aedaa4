"""Builds the package's CUDA kernels from ``csrc/`` and loads them.

The sources are compiled at first use with ``nvcc``, one process per source,
all started together (the log ends with each source's seconds), and linked
into one shared library with a plain C interface (no PyTorch headers, so the
build takes seconds), loaded with ``ctypes``.  The library goes to ``_build/`` beside this file,
named by a hash of the sources and flags, so an edited source builds anew.
A missing ``nvcc`` or a failed build raises: there is no fallback.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PACKAGE = Path(__file__).resolve().parent
CSRC = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded = {}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            candidate = Path(os.environ[var]) / "bin" / "nvcc"
            if candidate.exists():
                return str(candidate)
    candidate = Path("/usr/local/cuda/bin/nvcc")  # the CUDA toolkit's default prefix
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc was not found (PATH, CUDA_HOME, CUDA_PATH): the CUDA toolkit is "
        "needed to build the kernels in torchcde_tpu_torch/csrc."
    )


def library_path():
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libtorchcde_kernels_{digest.hexdigest()[:16]}.so"


def build():
    """Compiles the kernels if the library for these sources is missing.

    Returns (path, seconds spent compiling, compiler log)."""
    path = library_path()
    log_path = path.with_suffix(".log")
    if path.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return path, 0.0, log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    sources = [src for src in _sources() if src.suffix == ".cu"]
    objects = [path.with_name(f"{src.stem}.{os.getpid()}.o") for src in sources]
    outputs = [obj.with_suffix(".log") for obj in objects]
    start = time.perf_counter()
    procs = []
    for src, obj, out in zip(sources, objects, outputs):
        with open(out, "w") as sink:
            procs.append(subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                          stdout=sink, stderr=subprocess.STDOUT, text=True))
    # Each source's seconds from the start, as the processes end.
    ended = {}
    while len(ended) < len(procs):
        for src, proc in zip(sources, procs):
            if src.name not in ended and proc.poll() is not None:
                ended[src.name] = time.perf_counter() - start
        time.sleep(0.05)
    log = "".join(out.read_text() for out in outputs)
    log += "".join(f"nvcc {name}: {ended[name]:.1f} s\n" for name in sorted(ended))
    failed = [proc.returncode for proc in procs if proc.returncode != 0]
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objects)],
                              capture_output=True, text=True)
        log += link.stdout + link.stderr
        failed = [link.returncode] if link.returncode != 0 else []
    seconds = time.perf_counter() - start
    for obj in objects + outputs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with exit code {failed[0]}:\n{log}")
    log_path.write_text(log)
    os.replace(tmp, path)
    return path, seconds, log


def load_library():
    """The kernels' shared library, built and loaded once per process."""
    if "lib" not in _loaded:
        path, _seconds, _log = build()
        _loaded["lib"] = ctypes.CDLL(str(path))
    return _loaded["lib"]
