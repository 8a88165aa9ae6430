"""ctypes bindings for the native host runtime (``host_runtime.cpp``).

Counterpart of ``accelerate_tpu/native/__init__.py``, with its own copy of
the C++ source. The library holds the host side of the data path: batch
assembly (row and column gathers, item stacking) and the positioned reads
and writes of checkpoint files, each spread over a thread pool; ctypes
releases the interpreter lock for the call.

The library is built with ``g++`` at first use into ``native/.build/``
(listed in ``.gitignore``) under a name that hashes the source and flags,
through a per-process temporary file renamed into place, so concurrent
builds never load a partly written file. Each function has a plain numpy
or Python version and takes it when the library is missing, the work is
small (below ``NATIVE_MIN_BYTES``, or one core), or
``ACCELERATE_DISABLE_NATIVE=1`` is set. ``PATHS`` counts which path each
call took; ``BUILD_ERROR`` holds the compiler's output when a build failed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "host_runtime.cpp"
BUILD_DIR = Path(__file__).resolve().parent / ".build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")

# Below this many bytes a plain numpy fancy-index wins, and on one core the
# parallel path cannot beat numpy's memcpy loop.
NATIVE_MIN_BYTES = 1 << 20
_NUM_THREADS = min(8, os.cpu_count() or 1)
_MULTICORE = (os.cpu_count() or 1) >= 2

# Calls per function and path ("native" or "plain") since the last reset.
PATHS: dict[str, dict[str, int]] = {}
BUILD_ERROR: str | None = None

_lock = threading.Lock()
_lib = None
_lib_failed = False


def reset_paths() -> None:
    PATHS.clear()


def count_path(name: str, native: bool) -> None:
    counts = PATHS.setdefault(name, {"native": 0, "plain": 0})
    counts["native" if native else "plain"] += 1


def native_disabled() -> bool:
    return os.environ.get("ACCELERATE_DISABLE_NATIVE", "").lower() in ("1", "true", "yes")


def lib_path() -> Path:
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode() + SRC.read_bytes())
    return BUILD_DIR / f"libhost_runtime_{digest.hexdigest()[:16]}.so"


def _build(target: Path) -> bool:
    global BUILD_ERROR
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    try:
        res = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            BUILD_ERROR = res.stdout + res.stderr
            return False
        os.replace(tmp, target)
        return True
    except (OSError, subprocess.TimeoutExpired) as exc:
        BUILD_ERROR = f"{type(exc).__name__}: {exc}"
        return False
    finally:
        tmp.unlink(missing_ok=True)


def get_lib():
    """The loaded library, built first if needed; None when it is disabled
    or cannot be built or loaded."""
    global _lib, _lib_failed, BUILD_ERROR
    if native_disabled():
        return None
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        target = lib_path()
        if not target.exists() and not _build(target):
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(target))
        except OSError as exc:
            BUILD_ERROR = f"load failed: {exc}"
            _lib_failed = True
            return None
        vp, i64, p_vp = ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p)
        lib.at_gather_rows.argtypes = [vp, i64, vp, i64, vp, ctypes.c_int]
        lib.at_gather_rows.restype = None
        lib.at_stack_ptrs.argtypes = [p_vp, i64, i64, vp, ctypes.c_int]
        lib.at_stack_ptrs.restype = None
        lib.at_gather_columns.argtypes = [p_vp, vp, i64, vp, i64, p_vp, ctypes.c_int]
        lib.at_gather_columns.restype = None
        lib.at_pread_segments.argtypes = [ctypes.c_char_p, vp, vp, p_vp, i64, ctypes.c_int]
        lib.at_pread_segments.restype = ctypes.c_int
        lib.at_pwrite_segments.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, i64, vp, vp, p_vp, i64, ctypes.c_int]
        lib.at_pwrite_segments.restype = ctypes.c_int
        lib.at_version.argtypes = []
        lib.at_version.restype = ctypes.c_int
        if lib.at_version() != 3:
            BUILD_ERROR = f"host_runtime version {lib.at_version()}, expected 3"
            _lib_failed = True
            return None
        _lib = lib
    return _lib


def _eligible(nbytes: int, force: bool):
    """The library when the work is large enough for it, else None."""
    return get_lib() if force or (_MULTICORE and nbytes >= NATIVE_MIN_BYTES) else None


def _normalize_indices(indices, n: int):
    """int64 contiguous in-range indices for the native path, or None when
    numpy's semantics (bool masks, out-of-range IndexError) must apply."""
    arr = np.asarray(indices)
    if arr.dtype == bool:
        return None
    idx = np.ascontiguousarray(arr, dtype=np.int64)
    if idx.size and (idx.min() < -n or idx.max() >= n):
        return None
    if idx.size and idx.min() < 0:
        idx = np.ascontiguousarray(np.where(idx < 0, idx + n, idx))
    return idx


def _row_bytes(a: np.ndarray) -> int:
    return a.dtype.itemsize * int(np.prod(a.shape[1:], dtype=np.int64))


def gather_rows(src: np.ndarray, indices, force: bool = False) -> np.ndarray:
    """``src[indices]``: a parallel memcpy gather for large batches, numpy
    fancy indexing otherwise."""
    idx = _normalize_indices(indices, len(src))
    if idx is None:
        count_path("gather_rows", False)
        return src[np.asarray(indices)]
    lib = _eligible(_row_bytes(src) * len(idx), force)
    if lib is None or not src.flags.c_contiguous or src.dtype.hasobject:
        count_path("gather_rows", False)
        return src[idx]
    out = np.empty((len(idx),) + src.shape[1:], dtype=src.dtype)
    lib.at_gather_rows(src.ctypes.data, _row_bytes(src), idx.ctypes.data, len(idx),
                       out.ctypes.data, _NUM_THREADS)
    count_path("gather_rows", True)
    return out


def gather_columns(columns: dict[str, np.ndarray], indices,
                   force: bool = False) -> dict[str, np.ndarray]:
    """``{k: column[indices]}`` for a dict-of-arrays dataset in one call."""
    names = list(columns)
    arrays = [columns[k] for k in names]
    idx = _normalize_indices(indices, len(arrays[0]))
    if idx is None:
        count_path("gather_columns", False)
        return {k: columns[k][np.asarray(indices)] for k in names}
    lib = _eligible(sum(_row_bytes(a) for a in arrays) * len(idx), force)
    if lib is None or not all(a.flags.c_contiguous and not a.dtype.hasobject for a in arrays):
        count_path("gather_columns", False)
        return {k: columns[k][idx] for k in names}
    outs = [np.empty((len(idx),) + a.shape[1:], dtype=a.dtype) for a in arrays]
    n = len(arrays)
    srcs = (ctypes.c_void_p * n)(*[a.ctypes.data for a in arrays])
    dsts = (ctypes.c_void_p * n)(*[o.ctypes.data for o in outs])
    row_bytes = np.asarray([_row_bytes(a) for a in arrays], dtype=np.int64)
    lib.at_gather_columns(srcs, row_bytes.ctypes.data, n, idx.ctypes.data, len(idx), dsts,
                          _NUM_THREADS)
    count_path("gather_columns", True)
    return dict(zip(names, outs))


def stack_items(items: list, force: bool = False) -> np.ndarray:
    """``np.stack(items)`` with a parallel memcpy for big uniform items."""
    arrays = [np.asarray(x) for x in items]
    first = arrays[0]
    lib = _eligible(first.nbytes * len(arrays), force)
    if lib is None or first.dtype.hasobject or not all(
            a.flags.c_contiguous and a.shape == first.shape and a.dtype == first.dtype
            for a in arrays):
        count_path("stack_items", False)
        return np.stack(arrays)
    out = np.empty((len(arrays),) + first.shape, dtype=first.dtype)
    ptrs = (ctypes.c_void_p * len(arrays))(*[a.ctypes.data for a in arrays])
    lib.at_stack_ptrs(ptrs, first.nbytes, len(arrays), out.ctypes.data, _NUM_THREADS)
    count_path("stack_items", True)
    return out


def pread_segments(path: str, offsets: list[int], sizes: list[int], dsts: list[int],
                   force: bool = False) -> bool:
    """Read ``sizes[i]`` bytes at ``offsets[i]`` of ``path`` into the host
    address ``dsts[i]``, in parallel. False, with nothing read, when the
    native path does not take the call (the caller reads in Python); raises
    ``OSError`` when a read fails. The caller keeps the buffers alive."""
    lib = _eligible(sum(sizes), force) if sizes else None
    if lib is None:
        return False
    n = len(sizes)
    offs = np.ascontiguousarray(offsets, dtype=np.int64)
    lens = np.ascontiguousarray(sizes, dtype=np.int64)
    ptrs = (ctypes.c_void_p * n)(*dsts)
    rc = lib.at_pread_segments(os.fsencode(path), offs.ctypes.data, lens.ctypes.data, ptrs,
                               n, _NUM_THREADS)
    if rc != 0:
        raise OSError(-rc, f"parallel read of {path} failed: {os.strerror(-rc)}")
    count_path("pread_segments", True)
    return True


def pwrite_segments(path: str, header: bytes, offsets: list[int], sizes: list[int],
                    srcs: list[int], force: bool = False) -> bool:
    """Create ``path``, write ``header`` at 0 and ``sizes[i]`` bytes from the
    host address ``srcs[i]`` at ``offsets[i]``, in parallel, then fsync.
    False, with nothing written, when the native path does not take the
    call; raises ``OSError`` when a write fails."""
    lib = _eligible(sum(sizes), force) if sizes else None
    if lib is None:
        return False
    n = len(sizes)
    offs = np.ascontiguousarray(offsets, dtype=np.int64)
    lens = np.ascontiguousarray(sizes, dtype=np.int64)
    ptrs = (ctypes.c_void_p * n)(*srcs)
    rc = lib.at_pwrite_segments(os.fsencode(path), header, len(header), offs.ctypes.data,
                                lens.ctypes.data, ptrs, n, _NUM_THREADS)
    if rc != 0:
        raise OSError(-rc, f"parallel write of {path} failed: {os.strerror(-rc)}")
    count_path("pwrite_segments", True)
    return True
