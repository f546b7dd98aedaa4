"""Input pipeline: coefficient dataloading with native host preprocessing.

Port of ``torchcde_tpu/data.py``.  Minibatch coefficient construction runs
on host threads through the multithreaded C++ kernels of
``torchcde_tpu_torch.native`` (ctypes releases the interpreter lock around
each call), and finished batches are copied to the card ahead of the
consumer, so preprocessing and the copy overlap the card's compute.

    loader = CoefficientDataLoader(x, y, batch_size=256,
                                   interpolation="hermite", prefetch=2)
    for coeffs, labels in loader:          # tensors on the card
        loss = train_step(coeffs, labels)

The copy to the card: the worker that made a batch pins it and copies it
with ``non_blocking=True`` on the loader's own copy stream, then records an
event.  The consumer makes its current stream wait on that event and
records the batch's tensors on its stream (``record_stream``), so the
caching allocator does not reuse their memory while the consumer's work on
them is pending.  The pinned host buffers may be dropped as soon as the copy
is queued: PyTorch's pinned-memory allocator records an event on the copy's
stream and does not reuse a block until that event has completed.
"""

import queue
import threading

import numpy as np
import torch

from . import native


def _hermite_host(t, x):
    if np.isnan(x).any():
        # The Hermite path builds on linearly infilled data, as
        # hermite_cubic_coefficients_with_backward_differences does.
        x = native.linear_infill(t, x)
    return native.hermite_coeffs(t, x)


def _natural_cubic_host(t, x):
    if np.isnan(x).any():
        # The masked C++ kernel keeps NaN batches on the loader threads.
        return native.natural_cubic_masked(t, x)
    return native.natural_cubic_dense(t, x)


def _linear_host(t, x):
    if np.isnan(x).any():
        return native.linear_infill(t, x)
    return x


_PREPROCESSORS = {
    "hermite": _hermite_host,
    "cubic": _natural_cubic_host,
    "linear": _linear_host,
    # "logsig": built per loader (needs depth and window_length), see __init__.
}


class _Copied:
    """A batch on the card, copied on the copy stream; ``event`` completes
    when the copy has."""

    def __init__(self, tensors, event):
        self.tensors, self.event = tensors, event


class CoefficientDataLoader:
    """Iterates (coefficients, labels) minibatches with prefetching.

    Arguments:
        x: (N, length, channels) raw observations (NaNs = missing); NumPy.
        y: (N, ...) labels; NumPy.
        batch_size: minibatch size.
        interpolation: "hermite" | "cubic" | "linear" | "logsig": which
            coefficient construction to run per batch ("logsig" needs depth
            and window_length and yields ``logsig_windows``'s path, the
            linear-interpolation coefficients of a Neural RDE).
        t: optional 1-D times (defaults to 0..length-1).
        shuffle: reshuffle each epoch (``np.random.default_rng(seed)``, one
            permutation per epoch: the JAX package's order for the same seed).
        seed: shuffle seed.
        prefetch: number of batches prepared ahead of the consumer.
        device_put: yield tensors on ``device`` (else NumPy arrays).
        num_workers: preprocessing threads.  Batches are always yielded in
            order regardless of worker count; at most prefetch +
            num_workers - 1 are in flight.
        drop_last: when True (the DEFAULT), the final PARTIAL batch is
            **silently dropped**: every yielded batch has exactly
            ``batch_size`` rows.  Set False to also get the ragged tail.
        device: where ``device_put`` puts the batches; the CUDA card by
            default, which raises without one (pass ``device="cpu"`` there).
    """

    def __init__(self, x, y, batch_size, interpolation="hermite", t=None,
                 shuffle=True, seed=0, prefetch=2, device_put=True,
                 num_workers=1, drop_last=True, depth=None, window_length=None,
                 device="cuda"):
        if interpolation == "logsig":
            if depth is None or window_length is None:
                raise ValueError(
                    "interpolation='logsig' needs depth= and window_length=")
            d, wl = int(depth), float(window_length)
            self._fn = lambda t_, x_: native.logsig_windows_host(t_, x_, d, wl)
        elif interpolation not in _PREPROCESSORS:
            raise ValueError(
                f"Unknown interpolation {interpolation!r}; expected one of "
                f"{sorted(_PREPROCESSORS) + ['logsig']}"
            )
        else:
            self._fn = _PREPROCESSORS[interpolation]
        self._x = np.asarray(x)
        self._y = np.asarray(y)
        if self._x.shape[0] != self._y.shape[0]:
            raise ValueError(
                f"x and y disagree on the number of samples: "
                f"{self._x.shape[0]} vs {self._y.shape[0]}"
            )
        self._t = (
            np.asarray(t, dtype=self._x.dtype)
            if t is not None
            else np.arange(self._x.shape[-2], dtype=self._x.dtype)
        )
        if self._t.shape != (self._x.shape[-2],):
            raise ValueError(
                f"t must be 1-D with length {self._x.shape[-2]}; got shape "
                f"{self._t.shape}"
            )
        self._device = torch.device(device)
        if device_put and self._device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "CoefficientDataLoader puts batches on the CUDA card by default, and "
                "torch.cuda.is_available() is False: pass device='cpu' to keep them "
                "on the CPU."
            )
        self._batch_size = int(batch_size)
        self._shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self._prefetch = max(1, int(prefetch))
        self._device_put = device_put
        self._num_workers = max(1, int(num_workers))
        self._drop_last = bool(drop_last)

    def __len__(self):
        n, bs = self._x.shape[0], self._batch_size
        return n // bs if self._drop_last else -(-n // bs)

    def _make_batch(self, idx, copy_stream):
        coeffs = self._fn(self._t, self._x[idx])
        labels = self._y[idx]
        if not self._device_put:
            return coeffs, labels
        host = (torch.from_numpy(np.ascontiguousarray(coeffs)),
                torch.from_numpy(np.ascontiguousarray(labels)))
        if copy_stream is None:
            return tuple(h.to(self._device) for h in host)
        with torch.cuda.stream(copy_stream):
            tensors = tuple(h.pin_memory().to(self._device, non_blocking=True) for h in host)
            event = torch.cuda.Event()
            event.record(copy_stream)
        return _Copied(tensors, event)

    def __iter__(self):
        order = (
            self._rng.permutation(self._x.shape[0])
            if self._shuffle
            else np.arange(self._x.shape[0])
        )
        n_batches = len(self)
        on_card = self._device_put and self._device.type == "cuda"
        copy_stream = torch.cuda.Stream(self._device) if on_card else None
        stop = threading.Event()
        # In-flight bound: workers may run at most prefetch + num_workers - 1
        # batches ahead of the consumer.
        slots = threading.Semaphore(self._prefetch + self._num_workers - 1)
        tasks = queue.SimpleQueue()
        for i in range(n_batches):
            tasks.put(i)
        cond = threading.Condition()
        results = {}

        def worker():
            while True:
                slots.acquire()
                if stop.is_set():
                    return
                try:
                    i = tasks.get_nowait()
                except queue.Empty:
                    slots.release()
                    return
                idx = order[i * self._batch_size : (i + 1) * self._batch_size]
                try:
                    item = self._make_batch(idx, copy_stream)
                except BaseException as e:  # raised to the consumer at its batch
                    item = e
                with cond:
                    results[i] = item
                    cond.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self._num_workers)]
        for th in threads:
            th.start()
        try:
            for i in range(n_batches):
                with cond:
                    while i not in results:
                        cond.wait()
                    item = results.pop(i)
                slots.release()
                if isinstance(item, BaseException):
                    raise item
                if isinstance(item, _Copied):
                    stream = torch.cuda.current_stream(self._device)
                    stream.wait_event(item.event)
                    for tensor in item.tensors:
                        tensor.record_stream(stream)
                    item = item.tensors
                yield item
        finally:
            stop.set()
            for _ in threads:  # wake the workers waiting for a slot
                slots.release()
            for th in threads:
                th.join()
