"""Build the port's CUDA kernels with ``nvcc`` and bind them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface and compiles on its own
into a shared library for ``sm_90a``.  The build runs at first use, one
``nvcc`` per source, all started together, into
``<checkout>/build/repro_torch/<hash of the sources and flags>/``, so a
changed source never loads a stale library.  Every C entry point returns
``cudaGetLastError()`` after its launch; :func:`check` raises on anything
but 0.

Nothing here runs at import: the CPU tests import every module of the
port, and the CPU host has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64

#: library stem -> {C entry point: argtypes}; every entry returns an int.
SIGNATURES: dict[str, dict[str, list]] = {
    "page_gather": {
        "gather_pages": [_P, _P, _P, _I64, _I64, _P],
        "scatter_pages": [_P, _P, _P, _I64, _I64, _P],
    },
    "flash_attention": {
        "flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            ctypes.c_float, _I, _P],
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: wall seconds of the last build that compiled anything (None: none ran)
last_build_seconds: float | None = None


#: kernel name -> launches so far.  Each wrapper adds one exactly where it
#: launches its kernel, so a run can show it went through the kernel.
LAUNCHES: dict[str, int] = {"gather_pages": 0, "scatter_pages": 0,
                            "flash_attention": 0}
_COUNT_LOCK = threading.Lock()


def count_launch(name: str) -> None:
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


class KernelError(RuntimeError):
    """A kernel failed to build or to launch."""


def _nvcc() -> str:
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for stem in sorted(SIGNATURES):
        h.update(stem.encode())
        h.update((CSRC / f"{stem}.cu").read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, all in parallel;
    return stem -> library path.  Compiler output goes to ``<stem>.log``
    beside the library (``-Xptxas -v``: registers, shared memory, spills)."""
    global last_build_seconds
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    libs = {stem: out / f"lib{stem}.so" for stem in SIGNATURES}
    todo = [stem for stem, so in libs.items() if not so.exists()]
    if not todo:
        return libs
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    try:
        for stem in todo:
            tmp = out / f"lib{stem}.so.{os.getpid()}.tmp"
            log = open(out / f"{stem}.log", "w")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
            procs.append((stem, tmp, log, subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT)))
        failed = []
        for stem, tmp, log, proc in procs:
            rc = proc.wait()
            log.close()
            if rc != 0:
                failed.append(f"{stem} (nvcc exit {rc}):\n"
                              + (out / f"{stem}.log").read_text()[-4000:])
            else:
                os.replace(tmp, libs[stem])
        if failed:
            raise KernelError("kernel build failed: " + "\n".join(failed))
    finally:
        for _stem, _tmp, log, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    last_build_seconds = time.perf_counter() - t0
    return libs


def library(stem: str) -> ctypes.CDLL:
    """The loaded, bound library ``lib<stem>.so`` (built on first use)."""
    with _LOCK:
        lib = _LIBS.get(stem)
        if lib is None:
            for s, path in build_all().items():
                cdll = ctypes.CDLL(str(path))
                for fn, argtypes in SIGNATURES[s].items():
                    getattr(cdll, fn).argtypes = argtypes
                    getattr(cdll, fn).restype = ctypes.c_int
                _LIBS[s] = cdll
            lib = _LIBS[stem]
        return lib


def check(rc: int, what: str) -> None:
    """Raise unless a C entry point returned cudaSuccess (0)."""
    if rc != 0:
        raise KernelError(f"{what}: CUDA error {rc} at launch")
