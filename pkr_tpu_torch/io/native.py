"""ctypes bindings for the native ark reader (native/pkr_ark.cpp).

A copy of ``pkr_tpu/io/native.py`` for the port, with one change: the
library is compiled with g++ at first use into ``build/pkr_tpu_torch/`` at
the root of the checkout, never beside its source, under a name that
carries a hash of the source and the flags, so an edited source is rebuilt
and a stale library never loads.  As in the reference, every entry point
has a pure-python counterpart in pkr_tpu_torch.io.kaldi_ark, and entries the
native reader does not decode (pipes, gzip, other formats) go to it: the
native path is the fast lane for the training-input hot loop (crop-aware
CompressedMatrix decode straight into the transposed batch buffer).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "pkr_ark.cpp"
BUILD_DIR = _ROOT / "build" / "pkr_tpu_torch"
CXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-fPIC", "-std=c++17", "-shared")

_lib = None
_tried = False


def library_path() -> Path:
    """The library for the current source and flags."""
    blob = SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
    return BUILD_DIR / f"libpkr_ark-{hashlib.sha256(blob).hexdigest()[:16]}.so"


def _build(lib: Path) -> bool:
    # compile to a per-pid temp path and rename into place: concurrent
    # first users (test workers, several trainers on one host) would
    # otherwise race on the -o target and load a half-written library
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True)
        os.replace(tmp, lib)
        return True
    except (OSError, subprocess.CalledProcessError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not SOURCE.exists():
        return None
    path = library_path()
    if not path.exists() and not _build(path):
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    lib.pkr_mat_dims.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                 ctypes.POINTER(ctypes.c_int),
                                 ctypes.POINTER(ctypes.c_int)]
    lib.pkr_mat_dims.restype = ctypes.c_int
    lib.pkr_read_crop_t.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_float)]
    lib.pkr_read_crop_t.restype = ctypes.c_int
    lib.pkr_read_mat.argtypes = [ctypes.c_char_p, ctypes.c_long,
                                 ctypes.POINTER(ctypes.c_float), ctypes.c_long,
                                 ctypes.POINTER(ctypes.c_int),
                                 ctypes.POINTER(ctypes.c_int)]
    lib.pkr_read_mat.restype = ctypes.c_int
    lib.pkr_compress_matrix.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_long]
    lib.pkr_compress_matrix.restype = ctypes.c_long
    lib.pkr_cm_bound.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.pkr_cm_bound.restype = ctypes.c_long
    _lib = lib
    return _lib


def native_compress(mat: np.ndarray, method: int) -> Optional[bytes]:
    """CompressedMatrix encode via the native library (bit-identical to
    kaldi_ark's python codec — parity-tested); None = unavailable, caller
    falls back to python."""
    lib = get_lib()
    if lib is None:
        return None
    mat = np.ascontiguousarray(mat, dtype=np.float32)
    rows, cols = mat.shape
    cap = int(lib.pkr_cm_bound(rows, cols))  # the library's own bound
    out = np.empty(cap, np.uint8)
    n = lib.pkr_compress_matrix(
        mat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), rows, cols,
        int(method),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), cap)
    if n <= 0:
        return None
    return out[:n].tobytes()


def available() -> bool:
    return get_lib() is not None


def split_rxspec(rx: str) -> Optional[Tuple[str, int]]:
    """'path:offset' or plain path → (path, offset); None for anything the
    native reader cannot handle (pipes, gzip — with or without an offset —
    and 'ark:'/'scp:' prefixed specs), which stays on the python codec."""
    rx = rx.strip()
    if rx.endswith("|") or rx.startswith("|") or rx.endswith(".gz"):
        return None
    head, sep, rest = rx.partition(":")
    if sep and head.split(",")[0] in ("ark", "scp"):
        return None  # prefixed spec: open_or_fd semantics, python path
    head, sep, tail = rx.rpartition(":")
    if sep and tail.isdigit() and head:
        return (None if head.endswith(".gz") else (head, int(tail)))
    return rx, 0


def mat_dims(path: str, offset: int = 0) -> Tuple[int, int]:
    lib = get_lib()
    assert lib is not None
    r, c = ctypes.c_int(), ctypes.c_int()
    rc = lib.pkr_mat_dims(path.encode(), offset, ctypes.byref(r), ctypes.byref(c))
    if rc != 0:
        raise IOError(f"pkr_mat_dims({path}:{offset}) failed rc={rc}")
    return r.value, c.value


def read_mat(path: str, offset: int = 0) -> np.ndarray:
    lib = get_lib()
    assert lib is not None
    rows, cols = mat_dims(path, offset)
    out = np.empty((rows, cols), np.float32)
    r, c = ctypes.c_int(), ctypes.c_int()
    rc = lib.pkr_read_mat(path.encode(), offset,
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                          out.size, ctypes.byref(r), ctypes.byref(c))
    if rc != 0:
        raise IOError(f"pkr_read_mat({path}:{offset}) failed rc={rc}")
    return out


def read_crop_t(path: str, offset: int, row_start: int, n_rows: int,
                cols: int, out: Optional[np.ndarray] = None) -> np.ndarray:
    """Decode rows [row_start, row_start+n_rows) transposed → (cols, n_rows)
    float32 (cyclically tiled when the matrix is shorter)."""
    lib = get_lib()
    assert lib is not None
    if out is None:
        out = np.empty((cols, n_rows), np.float32)
    rc = lib.pkr_read_crop_t(path.encode(), offset, row_start, n_rows, cols,
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise IOError(f"pkr_read_crop_t({path}:{offset}) failed rc={rc}")
    return out
