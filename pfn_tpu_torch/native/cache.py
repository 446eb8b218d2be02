"""ctypes binding and Python API of the C++ mmap batch cache.

Port of ``pfn_tpu/native/cache.py``. ``batch_cache.cpp`` (the same source as
the JAX package's) holds the file format; a cache written by either package
reads in the other. The library is compiled with g++ on first use into
``build/pfn_tpu_torch/`` at the root of the checkout (never into the package
directory), under a name that carries the hash of its source and flags.
Without a C++ toolchain the writer falls back to an ``.npz`` file and
:class:`NumpyBatchCacheReader` reads it; :func:`open_cache` raises, rather
than read something else, when a native cache exists and the library is
unavailable.

On the torch side:
  * :func:`write_prior_cache` renders batches of a port prior from a
    ``torch.Generator`` (on its device) and stores them;
  * :class:`CachedPrior` serves them: ``sample`` picks a record with a
    generator, ``training_iter`` feeds ``train(data_iter=...)``. A record
    read from the mmap is a zero-copy, read-only numpy view; both copy it
    once, into pinned host memory where there is a card, so that the copy to
    the device can run asynchronously (``sample``) or from the train loop's
    pinned batch (``training_iter``);
  * :class:`PrefetchIterator` reads ahead in a background thread.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import queue
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

_SRC = Path(__file__).resolve().parent / "batch_cache.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pfn_tpu_torch"
CXX_FLAGS = ("-O2", "-shared", "-fPIC")

_lib = None
_lib_error: str | None = None


def library_path() -> Path:
    """Where the library of this source and these flags is built."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libbatch_cache-{digest}.so"


def _build_library() -> Path:
    """Compile the shared library unless it is there. Returns its path."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
    subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(_SRC)], check=True, capture_output=True)
    os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
    return so


def _load():
    global _lib, _lib_error
    if _lib is not None or _lib_error is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(_build_library()))
    except (OSError, subprocess.CalledProcessError) as e:  # no g++ or an unwritable build dir: the npz fallback
        _lib_error = str(e)
        return None
    lib.bc_open.restype = ctypes.c_void_p
    lib.bc_open.argtypes = [ctypes.c_char_p]
    lib.bc_num_records.restype = ctypes.c_int64
    lib.bc_num_records.argtypes = [ctypes.c_void_p]
    lib.bc_record_floats.restype = ctypes.c_int64
    lib.bc_record_floats.argtypes = [ctypes.c_void_p]
    lib.bc_meta.restype = ctypes.c_char_p
    lib.bc_meta.argtypes = [ctypes.c_void_p]
    lib.bc_record_ptr.restype = ctypes.POINTER(ctypes.c_float)
    lib.bc_record_ptr.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.bc_read.restype = ctypes.c_int
    lib.bc_read.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_float)]
    lib.bc_close.argtypes = [ctypes.c_void_p]
    lib.bcw_create.restype = ctypes.c_void_p
    lib.bcw_create.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p]
    lib.bcw_append.restype = ctypes.c_int
    lib.bcw_append.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
    lib.bcw_num_records.restype = ctypes.c_int64
    lib.bcw_num_records.argtypes = [ctypes.c_void_p]
    lib.bcw_finish.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def _split(flat: np.ndarray, shapes: dict) -> dict:
    """{name: view} of one flat record, the arrays in sorted name order."""
    out, off = {}, 0
    for k in sorted(shapes):
        n = int(np.prod(shapes[k]))
        out[k] = flat[off: off + n].reshape(shapes[k])
        off += n
    return out


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

class BatchCacheWriter:
    """Append (x, y, target_y) batches of one fixed shape to a cache file.
    The metadata records each array's shape, so that readers can split the
    flat record."""

    def __init__(self, path: str, shapes: dict):
        self.path = path
        self.shapes = {k: tuple(v) for k, v in shapes.items()}
        self.record_floats = sum(int(np.prod(v)) for v in self.shapes.values())
        meta = json.dumps({"shapes": {k: list(v) for k, v in self.shapes.items()}})
        self._finished = None
        self._lib = _load()
        if self._lib is not None:
            self._h = self._lib.bcw_create(path.encode(), self.record_floats, meta.encode())
            if not self._h:
                raise OSError(f"cannot create a cache at {path}")
        else:  # the numpy fallback: records in RAM, saved on finish
            self._h = None
            self._buf: list[np.ndarray] = []
            self._meta = meta

    def append(self, **arrays) -> None:
        if set(arrays) != set(self.shapes):
            raise ValueError(f"arrays {sorted(arrays)} differ from the cache's {sorted(self.shapes)}")
        flat = np.concatenate([np.asarray(arrays[k], np.float32).reshape(-1) for k in sorted(self.shapes)])
        if flat.size != self.record_floats:
            raise ValueError(f"a record of {flat.size} floats, the cache holds {self.record_floats}")
        if self._h is not None:
            if self._lib.bcw_append(self._h, flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float))) != 0:
                raise OSError(f"append to {self.path} failed")
        else:
            self._buf.append(flat)

    def finish(self) -> int:
        """Close the file; returns the number of records. Idempotent."""
        if self._finished is not None:
            return self._finished
        if self._h is not None:
            n = int(self._lib.bcw_num_records(self._h))
            self._lib.bcw_finish(self._h)
            self._h = None
            self._finished = n
            return n
        records = np.stack(self._buf) if self._buf else np.zeros((0, self.record_floats), np.float32)
        np.savez(self.path + ".npz", records=records, meta=self._meta)
        self._finished = len(self._buf)
        return self._finished

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finish()


# ---------------------------------------------------------------------------
# Readers
# ---------------------------------------------------------------------------

class BatchCacheReader:
    """Zero-copy reader of a cache file (mmap through the C++ library)."""

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native batch cache unavailable ({_lib_error}); use NumpyBatchCacheReader")
        self._lib = lib
        self._h = lib.bc_open(path.encode())
        if not self._h:
            raise FileNotFoundError(f"not a batch cache: {path}")
        self.num_records = int(lib.bc_num_records(self._h))
        self.record_floats = int(lib.bc_record_floats(self._h))
        meta = json.loads(lib.bc_meta(self._h).decode())
        self.shapes = {k: tuple(v) for k, v in meta["shapes"].items()}

    def record(self, idx: int, copy: bool = False) -> dict:
        """{name: array} of record ``idx``: by default a zero-copy, read-only
        view into the mmap, valid until ``close``."""
        ptr = self._lib.bc_record_ptr(self._h, idx)
        if not ptr:
            raise IndexError(idx)
        flat = np.ctypeslib.as_array(ptr, shape=(self.record_floats,))
        flat.flags.writeable = False
        return _split(flat.copy() if copy else flat, self.shapes)

    def __len__(self):
        return self.num_records

    def __getitem__(self, idx):
        return self.record(idx)

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.bc_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


class NumpyBatchCacheReader:
    """The numpy fallback's reader of the ``.npz`` its writer saves."""

    def __init__(self, path: str):
        data = np.load(path + ".npz", allow_pickle=False)
        self._records = data["records"]
        meta = json.loads(str(data["meta"]))
        self.shapes = {k: tuple(v) for k, v in meta["shapes"].items()}
        self.num_records = len(self._records)
        self.record_floats = self._records.shape[1] if self.num_records else 0

    def record(self, idx: int, copy: bool = False) -> dict:
        return _split(self._records[idx], self.shapes)

    def __len__(self):
        return self.num_records

    def __getitem__(self, idx):
        return self.record(idx)

    def close(self) -> None:
        pass


def open_cache(path: str):
    """Open whichever representation exists at ``path``; raise if the
    native cache exists and the native reader is unavailable."""
    if os.path.exists(path) and native_available():
        return BatchCacheReader(path)
    if os.path.exists(path + ".npz"):
        return NumpyBatchCacheReader(path)
    if os.path.exists(path):
        raise RuntimeError(f"cache {path} exists but the native reader is unavailable")
    raise FileNotFoundError(path)


# ---------------------------------------------------------------------------
# Prior integration (use_saved_from parity, reference stroke.py:81-84)
# ---------------------------------------------------------------------------

def write_prior_cache(path: str, prior, num_batches: int, batch_size: int, seq_len: int,
                      generator: torch.Generator) -> int:
    """Render ``num_batches`` batches of ``prior`` from ``generator`` (on its
    device) once and store them. Returns the number of records."""
    if num_batches < 1:
        raise ValueError(f"num_batches must be >= 1, got {num_batches}")
    writer = None
    for _ in range(num_batches):
        x, y, t = (a.cpu().numpy() for a in prior.sample(batch_size, seq_len, generator=generator,
                                                         device=generator.device))
        if writer is None:
            writer = BatchCacheWriter(path, {"x": x.shape, "y": y.shape, "target_y": t.shape})
        writer.append(x=x, y=y, target_y=t)
    return writer.finish()


def _host_tensor(a: np.ndarray, pin_memory: bool) -> torch.Tensor:
    """One copy of ``a`` (an mmap view, read-only) into a new CPU tensor,
    pinned if ``pin_memory``."""
    t = torch.empty(a.shape, dtype=torch.float32, pin_memory=pin_memory)
    t.numpy()[...] = a
    return t


class CachedPrior:
    """Serve batches from a cache instead of sampling (use_saved_from
    parity: the reference picks a random saved file per step,
    stroke.py:81-84; here a random record of the mmap). ``batch_size`` and
    ``seq_len`` must match the cached shapes."""

    def __init__(self, path: str, num_features: int | None = None, num_outputs: int = 1):
        self.reader = open_cache(path)
        x_shape = self.reader.shapes["x"]
        self.num_features = num_features or x_shape[-1]
        self.num_outputs = num_outputs
        self._cached_shape = x_shape

    def sample(self, batch_size: int, seq_len: int, generator: torch.Generator | None = None, device=None):
        """(x, y, target_y) of a record drawn from ``generator``, on
        ``device`` (the pick is read on the host: one sync)."""
        B, T, _ = self._cached_shape
        if (batch_size, seq_len) != (B, T):
            raise ValueError(f"the cache holds shape {self._cached_shape}, requested ({batch_size}, {seq_len})")
        gen_device = generator.device if generator is not None else "cpu"
        idx = int(torch.randint(0, len(self.reader), (), generator=generator, device=gen_device))
        rec = self.reader.record(idx)
        device = torch.device(device if device is not None else "cpu")
        pin = device.type == "cuda"
        return tuple(_host_tensor(rec[k], pin).to(device, non_blocking=pin) for k in ("x", "y", "target_y"))

    def training_iter(self, seed: int = 0, prefetch: int = 0, pin_memory: bool | None = None):
        """An endless iterator of ``(x, y, target_y)`` CPU tensors of random
        cached batches (records drawn by ``np.random.RandomState(seed)``),
        for ``train(..., data_iter=...)``; each record copied once out of
        the mmap, into pinned memory if ``pin_memory`` (default: where there
        is a card). ``prefetch > 0`` reads ahead in a background thread
        (:class:`PrefetchIterator`)."""
        pin = torch.cuda.is_available() if pin_memory is None else pin_memory

        def gen():
            rng = np.random.RandomState(seed)
            n = len(self.reader)
            while True:
                rec = self.reader.record(int(rng.randint(n)))
                yield tuple(_host_tensor(rec[k], pin) for k in ("x", "y", "target_y"))

        return PrefetchIterator(gen(), depth=prefetch) if prefetch else gen()


_SENTINEL = object()


class PrefetchIterator:
    """Background-thread prefetch: overlaps host IO (mmap reads, the copy
    into host tensors) with the device's work in the host-fed train path, the
    role the reference's DataLoader workers play, without processes. A
    failure of the worker is raised at the consumer."""

    def __init__(self, it, depth: int = 2):
        self._queue: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self._done = False

        def worker():
            try:
                for item in it:
                    if self._stop.is_set():
                        return
                    self._queue.put(item)
            except BaseException as e:  # re-raised at the consumer
                self._error = e
            finally:
                # A bounded put: after close() the queue may stay full (the
                # consumer is gone), so give up instead of blocking for ever;
                # at most 60 s of 10 Hz retries.
                for _ in range(600):
                    if self._stop.is_set():
                        break
                    try:
                        self._queue.put(_SENTINEL, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def _end(self):
        self._done = True
        if self._error is not None:
            raise self._error  # the worker's failure, not a bare stop
        raise StopIteration

    def __next__(self):
        if self._done:
            raise StopIteration
        while True:
            try:
                item = self._queue.get(timeout=0.5)
            except queue.Empty:
                if self._thread.is_alive():
                    continue
                # The worker is gone without its sentinel reaching us (its
                # bounded put gave up while the consumer stalled); it may
                # still have queued items just before it ended.
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    self._end()
            if item is _SENTINEL:
                self._end()
            return item

    def close(self) -> None:
        self._done = True  # a later __next__ stops at once
        self._stop.set()
        while not self._queue.empty():  # unblock a worker waiting on a full queue
            self._queue.get_nowait()
        self._thread.join(timeout=1.0)
