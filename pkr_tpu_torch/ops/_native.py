"""Build and load the port's CUDA kernels at first use.

Each ``pkr_tpu_torch/csrc/<name>.cu`` has a plain C interface and is
compiled by ``nvcc`` for ``sm_90a`` (Hopper) into a shared library under
``build/pkr_tpu_torch/`` at the root of the checkout, then loaded with
``ctypes``.  The library's file name carries a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source is rebuilt
and a stale one never loads.  No PyTorch header is included, which keeps a
build to seconds; :func:`build_all` runs one ``nvcc`` per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "pkr_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# per kernel library: build seconds (0.0 when an earlier build was reused),
# the library path, and ptxas' registers / shared memory / spills per kernel
# (kept beside the library, so a reused build reports them too)
BUILD_INFO: Dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                       "the CUDA kernels are built on the machine with the card")


def _ptxas_usage(log: str) -> Dict[str, dict]:
    """Parse `-Xptxas -v` output into {kernel: {registers, smem_bytes, spill}}."""
    out: Dict[str, dict] = {}
    current = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = m.group(1)
            out[current] = {}
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[current]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[current]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            out[current]["smem_bytes"] = int(s.group(1)) if s else 0
    return out


def _library(name: str) -> Path:
    """The library path of csrc/<name>.cu for the current source and flags."""
    src = CSRC / f"{name}.cu"
    blob = src.read_bytes() + b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(blob + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _log(lib: Path) -> Path:
    """Where nvcc's output for a library is kept beside it."""
    return lib.with_name(f"{lib.name}.log")


def _start(name: str) -> Optional[Tuple[subprocess.Popen, Path, Path, float]]:
    """Start nvcc for csrc/<name>.cu unless its library exists."""
    lib = _library(name)
    if lib.exists():
        log = _log(lib)
        BUILD_INFO.setdefault(name, {"seconds": 0.0, "path": str(lib), "ptxas": _ptxas_usage(
            log.read_text() if log.exists() else "")})
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib, time.perf_counter()


def _finish(name: str, job: Tuple[subprocess.Popen, Path, Path, float]) -> None:
    proc, tmp, lib, t0 = job
    log, _ = proc.communicate()
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {CSRC / name}.cu:\n{log}")
    _log(lib).write_text(log)
    os.replace(tmp, lib)
    BUILD_INFO[name] = {"seconds": seconds, "path": str(lib), "ptxas": _ptxas_usage(log)}


def build_all(names: Iterable[str]) -> None:
    """Compile every csrc/<name>.cu whose library is missing, one nvcc each,
    all running at once."""
    jobs = {name: _start(name) for name in names}
    errors = []
    for name, job in jobs.items():
        if job is not None:
            try:
                _finish(name, job)
            except RuntimeError as exc:
                errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless the library for this exact source exists."""
    build_all([name])
    return _library(name)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if need be."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build(name)))
    return _LIBS[name]
