"""The host-side preprocessing runtime: multithreaded C++ through ctypes.

Port of ``torchcde_tpu/native/__init__.py``: coefficient construction on the
host CPU, on the loader's threads (``torchcde_tpu_torch.data``), so it
overlaps the card's compute.  ctypes releases the interpreter lock around
every call into the library.

The library is built at first use with ``g++`` from ``src/cdehost.cpp`` into
the package's ``_build/``, named by a hash of the source, the compiler and
its flags, so an edited source builds anew (never by modification time).  It
is written under a temporary name and renamed into place, so processes that
build at the same moment do not collide.  A missing compiler or a failed
build raises ``RuntimeError`` with the compiler's output: there is no
fallback to another implementation.  ``available()`` says whether the
library loads.

Public surface (the JAX package's names and argument checks):
    available() -> bool
    thomas_solve(b, u, d, l)            (batched, float32/float64)
    forward_fill(x)
    linear_infill(t, x)
    natural_cubic_dense(t, x) -> packed (a, b, 2c, 3d) coeffs
    natural_cubic_masked(t, x) -> the same, NaN-masked
    hermite_coeffs(t, x)      -> packed coeffs
    lyndon_words(channels, depth)
    logsig_window_values(x, boundaries, depth)
    logsig_windows_host(t, x, depth, window_length)
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from ..log_ode import _merge_window_grid

SRC = Path(__file__).resolve().parent / "src" / "cdehost.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lpthread",)

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_BATCHED = (_P, _P, _P, _I64, _I64, _I64, _INT)  # t, x, out, n, length, channels, threads
_SIGNATURES = {
    "thomas_solve_batch": (_P, _P, _P, _P, _P, _I64, _I64, _INT),
    "forward_fill": (_P, _P, _I64, _I64, _I64, _INT),
    "linear_infill": _BATCHED,
    "natural_cubic_dense": _BATCHED,
    "natural_cubic_masked": _BATCHED,
    "hermite_coeffs": _BATCHED,
    "logsig_windows": (_P, _P, _P, _I64, _I64, _I64, ctypes.c_int32, _I64, _P, _P, _I64,
                       _INT),
}


def library_path():
    """Where the library for this source, compiler and flags lives."""
    digest = hashlib.sha256(" ".join((CXX, *CXX_FLAGS, *LIBS)).encode())
    digest.update(SRC.read_bytes())
    return BUILD_DIR / f"libcdehost_{digest.hexdigest()[:16]}.so"


def build():
    """Compiles the library if the one for this source is missing.

    Returns (path, seconds spent compiling)."""
    path = library_path()
    if path.exists():
        return path, 0.0
    compiler = shutil.which(CXX)
    if compiler is None:
        raise RuntimeError(
            f"{CXX} was not found on PATH: a C++17 compiler is needed to build "
            f"the host preprocessing runtime from {SRC}."
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    start = time.perf_counter()
    proc = subprocess.run([compiler, *CXX_FLAGS, "-o", str(tmp), str(SRC), *LIBS],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - start
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{CXX} failed with exit code {proc.returncode}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path, seconds


def _declare(lib):
    for name, argtypes in _SIGNATURES.items():
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{name}_{suffix}")
            fn.argtypes, fn.restype = argtypes, None
    lib.lyndon_words_c.argtypes = (ctypes.c_int32, ctypes.c_int32, _P, _P, _P)
    lib.lyndon_words_c.restype = ctypes.c_int64
    return lib


def _load():
    """The loaded library; builds it on first use.  Raises if it cannot."""
    global _lib
    with _lock:
        if _lib is None:
            path, _seconds = build()
            _lib = _declare(ctypes.CDLL(str(path)))
    return _lib


def available() -> bool:
    """Whether the library builds and loads.  The functions below raise
    the build's error themselves; this only asks."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def _default_threads():
    return max(1, os.cpu_count() or 1)


def _ptr(arr):
    return arr.ctypes.data_as(ctypes.c_void_p)


def _suffix(dtype):
    if dtype == np.float32:
        return "f32"
    if dtype == np.float64:
        return "f64"
    raise TypeError(f"Unsupported dtype {dtype}")


def _rows(shape, trailing):
    """The number of rows of a (..., *trailing-dims) array."""
    return int(np.prod(shape[:-trailing], dtype=np.int64)) if len(shape) > trailing else 1


def thomas_solve(b, u, d, l, n_threads=None):
    """Batched tridiagonal solve on the host.  b, d: (..., k); u, l: (..., k-1)."""
    lib = _load()
    b = np.ascontiguousarray(b)
    dt = b.dtype.type
    u = np.ascontiguousarray(np.broadcast_to(u, b.shape[:-1] + (b.shape[-1] - 1,)), dtype=dt)
    d = np.ascontiguousarray(np.broadcast_to(d, b.shape), dtype=dt)
    l = np.ascontiguousarray(np.broadcast_to(l, b.shape[:-1] + (b.shape[-1] - 1,)), dtype=dt)
    k = b.shape[-1]
    n = _rows(b.shape, 1)
    fn = getattr(lib, f"thomas_solve_batch_{_suffix(dt)}")
    out = np.empty_like(b)
    fn(_ptr(b), _ptr(u), _ptr(d), _ptr(l), _ptr(out), n, k,
       n_threads or _default_threads())
    return out


def _batched_call(name, t, x, out_last_dim_factor=1, out_rows_delta=0, n_threads=None):
    lib = _load()
    x = np.ascontiguousarray(x)
    t = np.ascontiguousarray(t, dtype=x.dtype)
    if t.shape != (x.shape[-2],):
        # The C++ kernels trust shapes; validate here or they read OOB.
        raise ValueError(
            f"t must be 1-D with length {x.shape[-2]} (the data's time "
            f"dimension); got shape {t.shape}"
        )
    fn = getattr(lib, f"{name}_{_suffix(x.dtype.type)}")
    L, C = x.shape[-2], x.shape[-1]
    out = np.empty(x.shape[:-2] + (L + out_rows_delta, C * out_last_dim_factor), dtype=x.dtype)
    fn(_ptr(t), _ptr(x), _ptr(out), _rows(x.shape, 2), L, C, n_threads or _default_threads())
    return out


def forward_fill(x, n_threads=None):
    """NaN fill-down along the length axis of x (..., length, channels)."""
    lib = _load()
    x = np.ascontiguousarray(x)
    fn = getattr(lib, f"forward_fill_{_suffix(x.dtype.type)}")
    out = np.empty_like(x)
    fn(_ptr(x), _ptr(out), _rows(x.shape, 2), x.shape[-2], x.shape[-1],
       n_threads or _default_threads())
    return out


def linear_infill(t, x, n_threads=None):
    """NaN infill matching linear_interpolation_coeffs (no rectilinear)."""
    return _batched_call("linear_infill", t, x, n_threads=n_threads)


def natural_cubic_dense(t, x, n_threads=None):
    """Natural cubic coefficients for fully-observed data, packed like
    natural_cubic_coeffs: (..., L - 1, 4 * C)."""
    return _batched_call("natural_cubic_dense", t, x, out_last_dim_factor=4,
                         out_rows_delta=-1, n_threads=n_threads)


def natural_cubic_masked(t, x, n_threads=None):
    """NaN-masked natural cubic coefficients (the ``natural_cubic_coeffs``
    _version=1 semantics), packed (..., L - 1, 4 * C), so NaN batches stay
    on the loader threads."""
    return _batched_call("natural_cubic_masked", t, x, out_last_dim_factor=4,
                         out_rows_delta=-1, n_threads=n_threads)


def hermite_coeffs(t, x, n_threads=None):
    """Hermite-with-backward-differences coefficients for fully-observed
    data, packed (..., L - 1, 4 * C)."""
    return _batched_call("hermite_coeffs", t, x, out_last_dim_factor=4, out_rows_delta=-1,
                         n_threads=n_threads)


def lyndon_words(channels, depth):
    """The Lyndon words of length 1..depth over channels letters, by
    (length, lexicographic) order, as ``ops.logsignature.lyndon_words``."""
    lib = _load()
    total = ctypes.c_int64(0)
    count = lib.lyndon_words_c(channels, depth, None, None, ctypes.byref(total))
    letters = np.empty(total.value, dtype=np.int32)
    lengths = np.empty(count, dtype=np.int32)
    lib.lyndon_words_c(channels, depth, _ptr(letters), _ptr(lengths), None)
    words = []
    pos = 0
    for n in lengths:
        words.append(tuple(int(v) for v in letters[pos : pos + n]))
        pos += n
    return tuple(words)


def logsig_window_values(x, boundaries, depth, n_threads=None):
    """Raw per-window logsignatures (Lyndon-word coordinates) of an infilled
    piecewise-linear path: the host twin of
    ``ops.logsignature.windowed_logsignatures``.

    x: (..., length, channels), NaN-free; boundaries: int (n_windows + 1,)
    indices into the length axis.  Returns (..., n_windows, n_logsig).
    """
    lib = _load()
    x = np.ascontiguousarray(x)
    b = np.ascontiguousarray(boundaries, dtype=np.int64)
    fn = getattr(lib, f"logsig_windows_{_suffix(x.dtype.type)}")
    L, C = x.shape[-2], x.shape[-1]
    if b.ndim != 1 or (b.size and (b.min() < 0 or b.max() > L - 1)):
        # The C++ kernel reads x[boundaries[w + 1]]: keep the reads in bounds.
        raise ValueError(
            f"boundaries must be 1-D indices into the length axis (0..{L - 1}); "
            f"got {b.tolist()}")
    words = lyndon_words(C, int(depth))
    word_level = np.ascontiguousarray([len(w) for w in words], dtype=np.int32)
    flat = []
    for w in words:
        idx = 0
        for letter in w:
            idx = idx * C + letter
        flat.append(idx)
    word_flat = np.ascontiguousarray(flat, dtype=np.int32)
    n_logsig = len(words)
    n_windows = b.shape[0] - 1
    out = np.empty(x.shape[:-2] + (n_windows, n_logsig), dtype=x.dtype)
    fn(_ptr(x), _ptr(out), _ptr(b), _rows(x.shape, 2), L, C, int(depth), n_windows,
       _ptr(word_level), _ptr(word_flat), n_logsig, n_threads or _default_threads())
    return out


def logsig_windows_host(t, x, depth, window_length, n_threads=None):
    """Host-side ``logsig_windows`` (the _version=1 semantics of
    ``torchcde_tpu_torch.log_ode``): window-grid merge, NaN-row insertion,
    linear infill, per-window logsignatures, X(t0) first row, cumulative
    sum, all on the loader's threads (NumPy and the C++ kernels)."""
    x = np.ascontiguousarray(x)
    t_np = np.asarray(t, dtype=np.float64)
    merged, boundaries, _new_t = _merge_window_grid(t_np, float(window_length))
    if merged.shape[0] != t_np.shape[0]:
        insert_mask = ~np.isin(merged, t_np)
        full = np.full(x.shape[:-2] + (merged.shape[0], x.shape[-1]), np.nan, dtype=x.dtype)
        full[..., ~insert_mask, :] = x
        x = full
    if np.isnan(x).any():
        x = linear_infill(merged.astype(x.dtype), x, n_threads=n_threads)
    vals = logsig_window_values(x, boundaries, depth, n_threads=n_threads)
    C = x.shape[-1]
    first = np.zeros(x.shape[:-2] + (1, vals.shape[-1]), dtype=x.dtype)
    first[..., 0, :C] = x[..., 0, :]
    return np.cumsum(np.concatenate([first, vals], axis=-2), axis=-2)
