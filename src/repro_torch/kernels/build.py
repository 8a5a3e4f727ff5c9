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

import torch

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
        "gather_pages": [_P, _P, _P, _I64, _I64, _I64, _P],
        "scatter_pages": [_P, _P, _P, _I64, _I64, _I64, _P],
    },
    "flash_attention": {
        "flash_attention": [_P] * 5 + [_I] * 6 + [ctypes.c_float, _I, _P],
        "flash_attention_bwd": [_P] * 10 + [_I] * 6 + [ctypes.c_float, _I, _P],
    },
    "decode_attention": {
        "decode_attention": [_P] * 8 + [_I] * 7 + [ctypes.c_float] + [_I64] * 8
                            + [_P],
    },
    "mamba2_scan": {
        "ssd_scan": [_P] * 8 + [_I] * 5 + [_I64] * 3 + [_I, _P],
        "ssd_scan_bwd": [_P] * 19 + [_I] * 5 + [_I64] * 3 + [_I, _P],
    },
    "elementwise": {
        "norm_rows": [_P, _P, _P, _I64, _I, _I64, _I, _I, ctypes.c_float, _P],
        "rope_qk": [_P] * 6 + [_I] * 6 + [_I64] * 7 + [_P],
        "swiglu": [_P, _P, _P, _I64, _I, _I64, _I64, _I, _P],
    },
    "rwkv6_scan": {
        "wkv6_scan": [_P] * 8 + [_I] * 4 + [_I64] * 12 + [_I, _P],
        "wkv6_scan_bwd": [_P] * 17 + [_I] * 4 + [_I64] * 12 + [_I, _P],
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: wall seconds of the last build that compiled anything (None: none ran)
last_build_seconds: float | None = None


#: kernel name -> launches so far.  Each wrapper adds one exactly where it
#: launches its kernel, so a run can show it went through the kernel.
LAUNCHES: dict[str, int] = {"gather_pages": 0, "scatter_pages": 0,
                            "flash_attention": 0, "flash_attention_bwd": 0,
                            "decode_attention": 0, "ssd_scan": 0, "ssd_scan_bwd": 0,
                            "wkv6_scan": 0, "wkv6_scan_bwd": 0,
                            "norm": 0, "rope": 0, "swiglu": 0}
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
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
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


def aligned16(t) -> bool:
    """Whether each row of ``t`` (its last dimension) starts on a 16-byte
    boundary wherever the other indices point: the kernels that copy rows
    in 16-byte pieces need it.  Strides of dimensions of length 1 do not
    matter."""
    isz = t.element_size()
    return (t.data_ptr() % 16 == 0 and t.shape[-1] * isz % 16 == 0
            and all(s * isz % 16 == 0 for s, n in zip(t.stride()[:-1], t.shape[:-1])
                    if n > 1))


def refuse_grad(name: str, *tensors) -> None:
    """Raise where a kernel without a backward would be put in an autograd
    graph: a CUDA input that requires grad while grad is enabled.  The
    kernel's output would carry no ``grad_fn``, and every gradient upstream
    of it would go silently missing.  (CPU tensors take the plain version,
    which autograd differentiates.)  Decode and the page install run under
    no grad, so their kernels (B4, B1, B2) have no backward by design; the
    elementwise kernels have none yet, and ``nn.layers`` runs their plain
    versions wherever a graph is built."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise KernelError(
            f"{name} has no backward kernel: call it under torch.no_grad() or "
            "with inputs that do not require grad")


def check(rc: int, what: str) -> None:
    """Raise unless a C entry point returned cudaSuccess (0)."""
    if rc != 0:
        raise KernelError(f"{what}: CUDA error {rc} at launch")
