#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each (any failure raises and exits non-zero):

1. environment: the card, its power limit (``nvidia-smi``) and versions;
2. build: every kernel of ``src/repro_torch/csrc`` compiled with ``nvcc``
   for ``sm_90a`` (into ``build/repro_torch/``), then the scan kernels'
   registers, shared memory, spills and tensor-core instructions;
3. kernel checks: each kernel against its plain PyTorch version on the
   card at the main path's shapes, with its time, the plain version's,
   one library call's (a yardstick the port never calls) and its bound;
4. main path: full-width olmo-1b served through ``Orchestrator`` and
   ``Router`` -- register, a record request, scale to zero, a single cold
   start, a group restore of two, warm requests -- with the logits held
   to each other and to the plain versions on the card; then the group
   fuse's engines side by side;
5. fleet path: two spawned node processes (``build_fleet(...,
   transport="socket")``) over the same store serve a two-wide REAP cold
   burst, one cold start each with the WS crossing the process boundary,
   and three warm requests; logits held bitwise to the main path's, with
   each request's split, each node's transport stats and launch counts,
   one ``StatsSnapshotter`` sample, the spawn time, and the host's peak
   memory (the resident sets of parent and children summed, and the
   host's memory in use, which counts a shared page once);
6. decode paths through ``launch.steps``: full-width olmo-1b (bfloat16
   and int8 KV cache), zamba2-1.2b and rwkv6-7b (bfloat16, and a float32
   twin of each) prefill a 4 x 1024 prompt and decode greedily, each step
   held to a teacher-forced forward and to a run through the plain
   versions (the bfloat16 zamba2 and rwkv6 runs excepted: see
   ``F32_ATOL``), and each kernel call of a prefill and a decode step held
   to its plain version on the model's own inputs;
7. the launch counts of each path (counts set to 0 just before it, read
   just after; the fleet path's from its children), the kernel table,
   and the last line ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when no CUDA device is usable, or when the
port's sources are not beside this file.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12, "tf32": 495e12,   # tensor cores, dense
                  "float32": 67e12}                        # CUDA cores
FLASH_CASES = [                      # (B, S, H, KV, D, dtype)
    (2, 256, 4, 2, 64, "float32"),   # the four shapes of tests/test_kernels.py
    (1, 128, 8, 8, 128, "float32"),
    (2, 384, 6, 2, 80, "float32"),
    (1, 256, 4, 1, 64, "bfloat16"),
    (1, 64, 16, 16, 128, "bfloat16"),     # olmo-1b, the serving request
    (1, 2048, 16, 16, 128, "bfloat16"),   # olmo-1b, a long prompt
    (4, 1024, 16, 16, 128, "bfloat16"),   # olmo-1b prefill: the kernel table's row
    (4, 1056, 16, 16, 128, "bfloat16"),   # olmo-1b teacher-forced forward (ragged)
    (4, 1024, 32, 32, 64, "bfloat16"),    # zamba2-1.2b prefill
]
FLASH_ROW = (4, 1024, 16, 16, 128)      # B3's row of the kernel table
FLASH_ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
DECODE_CASES = [                     # (B, S, H, KV, D, dtype, kv_len or None = random)
    (2, 1024, 8, 2, 64, "float32", None),    # the three shapes of tests/test_kernels.py
    (1, 2048, 4, 4, 128, "float32", None),
    (3, 512, 16, 2, 80, "float32", None),
    (4, 1056, 16, 16, 128, "bfloat16", 1056),   # olmo-1b, the last decode step
    (4, 1056, 32, 32, 64, "bfloat16", 1056),    # zamba2-1.2b, the last decode step
]
SSD_CASES = [                        # (Bz, L, H, P, N, chunk, x dtype)
    (2, 256, 4, 64, 64, 64, "float32"),      # the three shapes of tests/test_kernels.py
    (1, 512, 2, 128, 32, 128, "float32"),
    (2, 128, 8, 32, 16, 32, "float32"),
    (4, 1024, 64, 64, 64, 128, "bfloat16"),  # zamba2-1.2b prefill
    (4, 1, 64, 64, 64, 1, "bfloat16"),       # zamba2-1.2b decode step
]
# float32 kernels: the tolerances of tests/test_kernels.py.  A bfloat16
# output is a softmax average over up to 1056 random keys, far below 1 in
# magnitude, so its bound is relative: both sides compute in float32 and
# round once to bfloat16, and a different order of summation flips that
# rounding by one ulp; four ulps at the output's largest magnitude.
DECODE_ATOL = {"float32": 2e-5}
KERNEL_ULPS = 4
SSD_ATOL = 5e-4
SSD_KERNEL_CHUNK = 32                # kLc in src/repro_torch/csrc/mamba2_scan.cu
WKV_CASES = [                        # (B, L, H, D, chunk, r/k/v dtype)
    (2, 128, 4, 64, 32, "float32"),          # the three shapes of tests/test_kernels.py
    (1, 256, 2, 32, 64, "float32"),
    (2, 96, 8, 16, 16, "float32"),
    (4, 1024, 64, 64, 32, "bfloat16"),       # rwkv6-7b prefill
    (4, 1, 64, 64, 1, "bfloat16"),           # rwkv6-7b decode step
]
WKV_ATOL = 1e-3                      # tests/test_kernels.py


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_in_turns(fns: dict, iters: int) -> dict:
    """``cuda_ms`` of each of ``fns`` ({name: fn}), timed in turns: in the
    given order, then in reverse, each the mean of its two readings, so a
    drift of the card's clocks falls on all alike."""
    order = list(fns) + list(fns)[::-1]
    seen: dict[str, list] = {name: [] for name in fns}
    for name in order:
        seen[name].append(cuda_ms(fns[name], iters))
    return {name: sum(ms) / len(ms) for name, ms in seen.items()}


def bf16_ulp(x) -> float:
    """One bfloat16 ulp at the magnitude of the largest |x|."""
    m = float(x.abs().max())
    return 2.0 ** (math.floor(math.log2(m)) - 7) if m > 0 else 0.0


def bound_ms(n_bytes: float, n_ops: float, dtype: str) -> tuple[float, str]:
    """The least time for the work: bytes over HBM rate vs operations over
    the peak rate of their type; the larger bounds it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[dtype] * 1e3 if n_ops else 0.0
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 1: environment ---------------------------------------------------


def phase_environment() -> dict:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    env = {"phase": "environment", "device": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(), "nvidia_smi": smi,
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "python": sys.version.split()[0]}
    emit(env)
    return env


# -- phase 2: build -----------------------------------------------------------


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all()
    for stem in libs:
        build.library(stem)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": build.last_build_seconds,
          "libraries": {s: str(p.relative_to(ROOT)) for s, p in libs.items()}})
    emit({"phase": "ptxas", "kernels": scan_kernel_report(build.build_dir(), libs)})


def short_names(mangled: list[str]) -> dict[str, str]:
    """Mangled kernel name -> ``name<template arguments>`` (``c++filt``;
    the mangled name where it is missing)."""
    import re
    try:
        out = subprocess.run(["c++filt"], input="\n".join(mangled), capture_output=True,
                             text=True, check=True, timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return {m: m for m in mangled}
    short = [re.sub(r"\(anonymous namespace\)::|^void |\(.*\)$", "", d) for d in out]
    return dict(zip(mangled, short))


def scan_kernel_report(out_dir, libs: dict) -> dict:
    """Registers, static shared memory and spills of each scan kernel (B5,
    B6) from the build's ``-Xptxas -v`` logs, and its HMMA (tensor-core
    mma) instructions in the built code (``cuobjdump -sass``; None
    without the tool)."""
    import re
    seen: dict[str, dict] = {}
    for stem in ("mamba2_scan", "rwkv6_scan"):
        fn = None
        for ln in (out_dir / f"{stem}.log").read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            if m:
                fn = m.group(1)
                seen[fn] = {"library": stem, "hmma": None}
            elif fn and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                                        r"stores, (\d+) bytes spill loads", ln)):
                seen[fn].update(stack=int(m[1]), spill_stores=int(m[2]),
                                spill_loads=int(m[3]))
            elif fn and (m := re.search(r"Used (\d+) registers", ln)):
                smem = re.search(r"(\d+) bytes smem", ln)
                seen[fn].update(registers=int(m[1]),
                                static_smem=int(smem[1]) if smem else 0)
        cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                                 "bin", "cuobjdump")
        try:
            sass = subprocess.run([cuobjdump, "-sass", str(libs[stem])], capture_output=True,
                                  text=True, check=True, timeout=300).stdout
        except (OSError, subprocess.SubprocessError):
            continue
        fn = None
        for ln in sass.splitlines():
            m = re.search(r"Function : (\w+)", ln)
            if m:
                fn = m.group(1)
                if fn in seen:
                    seen[fn]["hmma"] = 0
            elif fn in seen and "HMMA" in ln:
                seen[fn]["hmma"] += 1
    names = short_names(sorted(seen))
    return {names[m]: seen[m] for m in sorted(seen)}


# -- phase 3: kernel checks ----------------------------------------------------


def check_gather(n: int, row_bytes: int, iters: int) -> dict:
    """gather_pages at n rows of row_bytes, a random permutation as idx."""
    import torch
    from repro_torch.kernels.page_gather import gather_pages, page_gather_ref
    g = torch.Generator(device="cuda").manual_seed(n)
    table = torch.randint(0, 256, (n, row_bytes), dtype=torch.uint8,
                          device="cuda", generator=g)
    idx = torch.randperm(n, device="cuda", generator=g)
    out = gather_pages(table, idx)
    ref = page_gather_ref(table, idx)
    torch.cuda.synchronize()
    exact = bool(torch.equal(out, ref))
    b, by = bound_ms(2 * n * row_bytes + 8 * n, 0, "bfloat16")
    ms = cuda_ms_in_turns({"kernel_ms": lambda: gather_pages(table, idx),
                           "plain_ms": lambda: page_gather_ref(table, idx),
                           "library_ms": lambda: torch.index_select(table, 0, idx)},
                          iters)
    res = {"kernel": "gather_pages", "n": n, "row_bytes": row_bytes,
           "byte_exact": exact, "max_abs_err": 0.0 if exact else float("nan"),
           **ms, "bound_ms": b, "bound_by": by}
    del table, out, ref
    torch.cuda.empty_cache()
    return res


def check_scatter(n: int, row_bytes: int, iters: int) -> dict:
    """scatter_pages of n rows into 2n, a random distinct subset as idx."""
    import torch
    from repro_torch.kernels.page_gather import page_scatter_ref, scatter_pages
    g = torch.Generator(device="cuda").manual_seed(n + 1)
    ws = torch.randint(0, 256, (n, row_bytes), dtype=torch.uint8,
                       device="cuda", generator=g)
    idx = torch.randperm(2 * n, device="cuda", generator=g)[:n].contiguous()
    base = torch.randint(0, 256, (2 * n, row_bytes), dtype=torch.uint8,
                         device="cuda", generator=g)
    out = scatter_pages(ws, idx, base.clone())
    ref = page_scatter_ref(ws, idx, base.clone())
    torch.cuda.synchronize()
    exact = bool(torch.equal(out, ref))
    del out, ref
    dest = base.clone()
    b, by = bound_ms(2 * n * row_bytes + 8 * n, 0, "bfloat16")
    ms = cuda_ms_in_turns({"kernel_ms": lambda: scatter_pages(ws, idx, dest),
                           "plain_ms": lambda: page_scatter_ref(ws, idx, dest),
                           "library_ms": lambda: dest.index_copy_(0, idx, ws)},
                          iters)
    res = {"kernel": "scatter_pages", "n": n, "row_bytes": row_bytes,
           "byte_exact": exact, "max_abs_err": 0.0 if exact else float("nan"),
           **ms, "bound_ms": b, "bound_by": by}
    del ws, base, dest
    torch.cuda.empty_cache()
    return res


def check_flash(B: int, S: int, H: int, KV: int, D: int, dtype: str) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import mha, mha_ref
    rng = np.random.default_rng(S * 1000 + H)
    tdt = getattr(torch, dtype)

    def r(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to("cuda", tdt)
    q, k, v = r(B, S, H, D), r(B, S, KV, D), r(B, S, KV, D)

    def plain():
        return mha_ref(q, k, v)

    def library():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=H != KV)
    out = mha(q, k, v)
    ref = plain()
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    n_bytes = (q.numel() * 2 + k.numel() * 2) * q.element_size()
    n_ops = 4 * B * H * D * S * (S + 1) // 2     # QK^T and PV, causal half
    b, by = bound_ms(n_bytes, n_ops, dtype)
    library_kernels, library_device_ms = device_profile(library)
    return {"kernel": "flash_attention", "shape": [B, S, H, KV, D],
            "dtype": dtype, "max_abs_err": err, "atol": FLASH_ATOL[dtype],
            "ok": err <= FLASH_ATOL[dtype],
            # outputs that differ from the plain version's at all (in bf16:
            # those whose rounding flipped)
            "differing_share": float((out != ref).float().mean()),
            "kernel_ms": cuda_ms(lambda: mha(q, k, v), 50),
            "plain_ms": cuda_ms(plain, 20 if S <= 512 else 5),
            "library_ms": cuda_ms(library, 50),
            "kernel_device_ms": device_profile(lambda: mha(q, k, v))[1],
            "library_kernels": library_kernels,
            "library_device_ms": library_device_ms,
            "bound_ms": b, "bound_by": by}


def device_profile(fn, calls: int = 10, attempts: int = 3) -> tuple[list[str], float]:
    """The names of the device kernels ``fn`` runs, and its device
    milliseconds a call (its kernels' and copies' spans, summed, over
    ``calls`` traced calls): unlike CUDA-event times, these leave out the
    host's launch overhead.  A trace that caught no device span is taken
    again, up to ``attempts`` traces; then it raises, so a missed capture
    never reads as 0 ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        spans = device_spans(prof)
        if spans:
            ms = sum(e.time_range.end - e.time_range.start for e in spans) / 1e3 / calls
            return sorted({e.name for e in spans}), ms
    raise RuntimeError(f"the profiler caught no device span in {attempts} traces")


def check_decode(B: int, S: int, H: int, KV: int, D: int, dtype: str,
                 kv_len: int | None) -> dict:
    """gqa_decode against its plain version (and SDPA as the yardstick)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import gqa_decode, gqa_decode_ref
    rng = np.random.default_rng(S * 100 + H)
    tdt = getattr(torch, dtype)

    def r(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to("cuda", tdt)
    q, k, v = r(B, 1, H, D), r(B, S, KV, D), r(B, S, KV, D)
    lens = (rng.integers(1, S, B) if kv_len is None else np.full(B, kv_len))
    lens_d = torch.from_numpy(lens.astype(np.int32)).to("cuda")
    G = H // KV

    def plain():
        return gqa_decode_ref(q, k, v, lens_d)
    mask = (torch.arange(S, device="cuda")[None, :] < lens_d[:, None])[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=H != KV)
    out = gqa_decode(q, k, v, lens_d)
    ref = plain()
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    atol = DECODE_ATOL.get(dtype) or KERNEL_ULPS * bf16_ulp(ref.float())
    keys = int(lens.sum())               # the valid rows this data reads
    isz = q.element_size()
    n_bytes = 2 * q.numel() * isz + 4 * B + 2 * keys * KV * D * isz
    b, by = bound_ms(n_bytes, 4 * G * D * KV * keys, dtype)
    library_kernels, library_device_ms = device_profile(library)
    return {"kernel": "decode_attention", "shape": [B, S, H, KV, D],
            "kv_len": lens.tolist(), "dtype": dtype, "max_abs_err": err,
            "max_abs_out": float(ref.float().abs().max()), "atol": atol,
            "ok": err <= atol,
            "kernel_ms": cuda_ms(lambda: gqa_decode(q, k, v, lens_d), 50),
            "plain_ms": cuda_ms(plain, 20), "library_ms": cuda_ms(library, 20),
            "kernel_device_ms": device_profile(lambda: gqa_decode(q, k, v, lens_d))[1],
            "library_kernels": library_kernels,
            "library_device_ms": library_device_ms,
            "bound_ms": b, "bound_by": by}


def ssd_operations(Bz: int, L: int, H: int, P: int, N: int, chunk: int) -> dict:
    """Operations the chunked scan needs on these shapes, by product: per
    (b, chunk), C B^T over the causal half once (B and C are shared by the
    heads), and per head M x over the causal half, C h and the state
    update."""
    Lc = min(chunk, L)
    n = Bz * (-(-L // Lc))
    return {"CB": n * Lc * (Lc + 1) * N, "Mx": n * H * Lc * (Lc + 1) * P,
            "Ch": n * H * 2 * Lc * N * P, "update": n * H * 2 * Lc * N * P}


def check_ssd(Bz: int, L: int, H: int, P: int, N: int, chunk: int, xdt: str) -> dict:
    """ssd_scan against its plain version (no single library call computes
    it: library_ms is None)."""
    import numpy as np
    import torch
    from repro_torch.kernels.mamba2_scan import ssd_scan, ssd_scan_ref
    rng = np.random.default_rng(L * 10 + H)

    def r(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale
                                ).to("cuda")
    x = r(Bz, L, H, P).to(getattr(torch, xdt))
    dt, A = r(Bz, L, H, scale=0.1).abs(), -r(H).abs()
    B, C, h0 = r(Bz, L, N, scale=0.3), r(Bz, L, N, scale=0.3), r(Bz, H, N, P, scale=0.1)
    args = (x, dt, A, B, C, h0)
    y, hT = ssd_scan(*args, chunk=chunk)
    ry, rhT = ssd_scan_ref(*args, chunk=chunk)
    torch.cuda.synchronize()
    err = max(float((y - ry).abs().max()), float((hT - rhT).abs().max()))
    n_bytes = (x.numel() * x.element_size() + 4 * (dt.numel() + A.numel() + B.numel()
               + C.numel() + 2 * h0.numel() + y.numel()))
    # the kernel's route: split TF32 on the tensor cores over its own
    # chunk, three products a multiply-add where both operands are float32
    # (C B^T, C h), two where one is x in bfloat16 (M x, the state update)
    ops = ssd_operations(Bz, L, H, P, N, SSD_KERNEL_CHUNK)
    px = 2 if xdt == "bfloat16" else 3
    b, by = bound_ms(n_bytes, 3 * (ops["CB"] + ops["Ch"])
                     + px * (ops["Mx"] + ops["update"]), "tf32")
    # beside it, on this line only, PRs 12-14's bound: float32 on the CUDA
    # cores at the caller's chunk
    b32, by32 = bound_ms(n_bytes, sum(ssd_operations(Bz, L, H, P, N, chunk).values()),
                         "float32")
    return {"kernel": "ssd_scan", "shape": [Bz, L, H, P, N], "chunk": chunk,
            "x_dtype": xdt, "max_abs_err": err, "atol": SSD_ATOL, "ok": err <= SSD_ATOL,
            "kernel_ms": cuda_ms(lambda: ssd_scan(*args, chunk=chunk), 20),
            "plain_ms": cuda_ms(lambda: ssd_scan_ref(*args, chunk=chunk), 5),
            "kernel_device_ms": device_profile(lambda: ssd_scan(*args, chunk=chunk))[1],
            "library_ms": None, "bound_ms": b, "bound_by": by,
            "bound_fp32_ms": b32, "bound_fp32_by": by32}


def check_wkv6(B: int, L: int, H: int, D: int, chunk: int, dt: str) -> dict:
    """wkv6 against its plain version, on the value ranges of
    tests/test_kernels.py (a full-width ``host_initialize`` makes u, w0 and
    the token-shift mixes zero).  No single library call computes WKV6:
    library_ms is None."""
    import numpy as np
    import torch
    from repro_torch.kernels.rwkv6_scan import wkv6, wkv6_ref
    rng = np.random.default_rng(L * 10 + H)

    def r(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale
                                ).to("cuda")
    tdt = getattr(torch, dt)
    rr, k, v = r(B, L, H, D).to(tdt), r(B, L, H, D, scale=0.3).to(tdt), r(B, L, H, D).to(tdt)
    logw = -r(B, L, H, D, scale=0.5).abs() - 0.05
    u, s0 = r(H, D, scale=0.2), r(B, H, D, D, scale=0.1)
    args = (rr, k, v, logw, u, s0)
    y, sT = wkv6(*args, chunk=chunk)
    ry, rsT = wkv6_ref(*args, chunk=chunk)
    torch.cuda.synchronize()
    err = max(float((y - ry).abs().max()), float((sT - rsT).abs().max()))
    n_bytes = (3 * rr.numel() * rr.element_size()
               + 4 * (logw.numel() + u.numel() + 2 * s0.numel() + y.numel()))
    # per step and head: y_t = r_t S (D^2 multiply-adds), S <- w S + k v^T (D^2)
    b, by = bound_ms(n_bytes, 4 * B * L * H * D * D, "float32")
    return {"kernel": "wkv6_scan", "shape": [B, L, H, D], "chunk": chunk,
            "rkv_dtype": dt, "max_abs_err": err, "atol": WKV_ATOL, "ok": err <= WKV_ATOL,
            "kernel_ms": cuda_ms(lambda: wkv6(*args, chunk=chunk), 20),
            "plain_ms": cuda_ms(lambda: wkv6_ref(*args, chunk=chunk), 5),
            "kernel_device_ms": device_profile(lambda: wkv6(*args, chunk=chunk))[1],
            "library_ms": None, "bound_ms": b, "bound_by": by}


def phase_kernel_checks(ws_pages: int) -> dict:
    """Each kernel against its plain version; returns the main-path rows."""
    rows = {}
    for n, row_bytes, main in ((ws_pages, 4096, True), (10_000, 4100, False)):
        for fn in (check_gather, check_scatter):
            res = fn(n, row_bytes, iters=10 if main else 20)
            emit({"phase": "kernel_check", **res})
            if not res["byte_exact"]:
                raise AssertionError(f"{res['kernel']} differs from its plain "
                                     f"version at n={n} row_bytes={row_bytes}")
            if main:
                rows[res["kernel"]] = res
    for case in FLASH_CASES:
        res = check_flash(*case)
        emit({"phase": "kernel_check", **res})
        if not res["ok"]:
            raise AssertionError(f"flash_attention {case}: max abs err "
                                 f"{res['max_abs_err']} > {res['atol']}")
        if case[:5] == FLASH_ROW:
            rows["flash_attention"] = res
    for fn, cases, name, row_case in (
            (check_decode, DECODE_CASES, "decode_attention", DECODE_CASES[3]),
            (check_ssd, SSD_CASES, "ssd_scan", SSD_CASES[3]),
            (check_wkv6, WKV_CASES, "wkv6_scan", WKV_CASES[3])):
        for case in cases:
            res = fn(*case)
            emit({"phase": "kernel_check", **res})
            if not res["ok"]:
                raise AssertionError(f"{name} {case}: max abs err "
                                     f"{res['max_abs_err']} > {res['atol']}")
            if case == row_case:
                rows[name] = res
    return rows


# -- phase 4: main path -----------------------------------------------------

FUNCTION = "olmo-1b"
SEED = 0
REQUEST = (1, 64)                    # (batch, seq) of benchmarks/common.py
# Logits through the kernels vs through the plain versions, both in bf16 on
# the card.  The flash kernel and the exact-softmax plain version sum in a
# different order, so an attention output can round to the neighbouring
# bf16 value (max 2e-3 at the request's shape); 16 layers and the 2048-wide
# tied head carry such flips into logits of magnitude up to ~5, where one
# bf16 ulp is 0.03.  Four ulps there (measured on the H100: 0.064 cold,
# 0.090 warm).
LOGIT_ATOL = 0.125


def make_request(cfg, seed: int) -> dict:
    import numpy as np
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, REQUEST, dtype=np.int32)}


def expected_ws_pages(cfg, batch: dict) -> int:
    """Pages one invocation faults: infra, every param page but the
    embedding table's, and the table's pages at the request's tokens."""
    import numpy as np
    from repro_torch.core.arena import ArenaLayout
    from repro_torch.core.snapshot import instance_tensor_list
    layout = ArenaLayout.build(instance_tensor_list(cfg))
    pages = layout.region_pages("infra")
    rows = np.unique(batch["tokens"]).tolist()
    for path, e in layout.entries.items():
        if path == "params/embed/table":
            pages |= e.row_pages(rows)
        elif path.startswith("params/"):
            pages.update(e.pages())
    return len(pages)


def split(rep) -> dict:
    """The §4.2 latency split of one request's report."""
    return {"load_vmm_s": rep.load_vmm_s, "connection_s": rep.connection_s,
            "ws_fetch_s": rep.stages.ws_fetch_s, "install_s": rep.install_s,
            "processing_s": rep.processing_s,
            "n_prefetched_pages": rep.n_prefetched_pages,
            "n_faults": rep.n_faults, "tail_waits": rep.tail_waits,
            "batch_size": rep.batch_size}


def host_writeback() -> dict:
    """Dirty and under-writeback page cache, MB (/proc/meminfo): large
    values mean the snapshot's disk writes are still draining."""
    out = {}
    with open("/proc/meminfo") as f:
        for ln in f:
            key, val = ln.split(":", 1)
            if key in ("Dirty", "Writeback"):
                out[f"host_{key.lower()}_mb"] = int(val.split()[0]) / 1024
    return out


def device_spans(prof) -> list:
    """The device's own activity in a trace: kernels, copies and sets on
    the card, not the host ops that launched them (whose self device time
    repeats their kernels') nor annotations."""
    from torch.autograd import DeviceType
    return [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


def busy_ms(spans) -> float:
    """Milliseconds of the union of the spans' intervals (a moment two
    streams overlap counts once)."""
    total, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in spans):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total / 1e3


def profile_forward(fn, iters: int = 5, kernels: dict | None = None) -> dict:
    """Host milliseconds of one synchronised call, and the device's busy
    milliseconds in one call from torch.profiler (the union of the device
    activity's intervals; None when the profiler sees none), with the
    device milliseconds of each of ``kernels`` ({name: the fragments of
    its device kernels' names}), summed over the device kernels whose
    names contain one of its fragments.  The idle share sets the traced call's busy time against
    the untraced calls' host time: the profiler slows the host (up to 2x
    on a decode step, ``traced_wall_ms``) far more than the device, so the
    traced call's own host time would read the share high.  A call that
    keeps the device busy can read a share a little below 0."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / iters * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    spans = device_spans(prof)
    busy = busy_ms(spans)
    by_name: dict[str, float] = {}
    for e in spans:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    out = {"calls": iters + 2, "wall_ms": wall_ms, "traced_wall_ms": traced_ms,
           "device_busy_ms": busy or None,
           "device_idle_share": 1 - busy / wall_ms if busy else None,
           "device_launches": len(spans),
           "top_device_ms": {name[:60]: ms for name, ms in top}}
    if kernels:
        out["kernel_device_ms"] = {
            k: sum(ms for name, ms in by_name.items() if any(f in name for f in frags))
            for k, frags in kernels.items()}
    return out


def check_logits(label: str, logits, shape) -> None:
    import torch
    if tuple(logits.shape) != shape or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{label}: logits {tuple(logits.shape)} not finite "
                             f"or not of shape {shape}")


def run_main_path(cfg, device: str, store: str, batch: dict, t_start: float) -> dict:
    """Register, record, scale to zero, single cold start, group restore of
    two, warm requests; logits held to each other and to the plain
    versions.  Returns what the kernel table needs."""
    import torch
    from repro_torch.core.executor import LazyParams
    from repro_torch.core.restore import shutdown_tail_pool
    from repro_torch.models import get_family
    from repro_torch.serving import Orchestrator, Router, ServeConfig

    forward = get_family(cfg).forward
    shape = (*REQUEST, cfg.vocab)
    orch = Orchestrator(store, ServeConfig(device=device))
    router = None
    group = []

    def line(**kw):
        emit({"phase": "main_path", "t": time.perf_counter() - t_start, **kw,
              **host_writeback()})
    try:
        t0 = time.perf_counter()
        orch.register(FUNCTION, cfg, seed=SEED, warmup_batch=batch)
        line(step="register", seconds=time.perf_counter() - t0,
             arena_bytes=os.path.getsize(os.path.join(store, FUNCTION + ".mem")))
        router = Router(orch)

        def request(label):
            t = time.perf_counter()
            logits, rep = router.invoke(FUNCTION, batch)
            line(step=label, seconds=time.perf_counter() - t, **split(rep))
            check_logits(label, logits, shape)
            return logits, rep

        record, rep = request("record")
        if rep.n_prefetched_pages != 0:
            raise AssertionError("the first request did not record")
        orch.scale_to_zero(FUNCTION)
        cold, rep = request("single_cold")
        ws_pages = rep.n_prefetched_pages
        if not ws_pages:
            raise AssertionError("the cold start prefetched no pages")
        if not torch.equal(record, cold):
            raise AssertionError("record logits != single-cold logits")

        t0 = time.perf_counter()
        group = orch.spawn_batch(FUNCTION, 2)
        line(step="group_restore", seconds=time.perf_counter() - t0,
             members=len(group))
        for i, inst in enumerate(group):
            if not inst.try_acquire():
                raise AssertionError("group member not dispatchable")
            logits, _ = inst.invoke(batch)
            inst.release()
            line(step=f"group_cold_{i}", **split(inst.report))
            check_logits(f"group_cold_{i}", logits, shape)
            if not torch.equal(logits, cold):
                raise AssertionError(f"group member {i} logits != single-cold logits")

        params = LazyParams(cfg, group[0].monitor.arena, device=device).tree()
        cold_plain = forward(cfg, params, batch, plain=True)
        del params
        cold_err = float((cold.float() - cold_plain.float()).abs().max())

        for inst in group:
            inst.make_warm()
        warm = [request(f"warm_{i}")[0] for i in range(3)]
        prof = profile_forward(lambda: forward(cfg, group[0]._warm_params, batch))
        line(step="warm_forward_profile", **prof)
        warm_plain = forward(cfg, group[0]._warm_params, batch, plain=True)
        warm_err = max(float((w.float() - warm_plain.float()).abs().max()) for w in warm)
        if any(not torch.equal(w, warm[0]) for w in warm):
            raise AssertionError("warm requests disagree")
        cold_warm = float((cold.float() - warm[0].float()).abs().max())
        line(step="logits", record_eq_single_cold=True, group_eq_single_cold=True,
             cold_kernel_vs_plain_max_abs=cold_err,
             warm_kernel_vs_plain_max_abs=warm_err, atol=LOGIT_ATOL,
             cold_vs_warm_max_abs=cold_warm)
        if cold_err > LOGIT_ATOL or warm_err > LOGIT_ATOL:
            raise AssertionError(f"logits through the kernels differ from the "
                                 f"plain versions: cold {cold_err}, warm {warm_err}")
        # deploy warm-up, record, single cold, 2 group, 3 warm, the profile
        forwards = 8 + prof["calls"]
        return {"ws_pages": ws_pages, "base": os.path.join(store, FUNCTION),
                "forwards": forwards, "cold": cold.cpu(), "warm": warm[0].cpu()}
    finally:
        for inst in group:
            inst.reclaim()
        if router is not None:
            router.close()
        orch.close()
        shutdown_tail_pool()


def phase_fuse_engines(base: str) -> dict:
    """The group install's fuse pass on the main path's WS: the numpy
    engine beside the CUDA engine's copy in, gather and copy out."""
    import warnings

    import numpy as np
    import torch
    from repro_torch.core.arena import PAGE
    from repro_torch.core.reap import WS_CACHE, ReapConfig
    from repro_torch.core.restore import fuse_ws_block
    from repro_torch.kernels import gather_pages
    pages, data, _hit = WS_CACHE.fetch(base, ReapConfig())
    idx = np.asarray(pages, dtype=np.int64)
    order = np.argsort(idx, kind="stable")
    t0 = time.perf_counter()
    _, block_np = fuse_ws_block(pages, data, engine="numpy")
    numpy_s = time.perf_counter() - t0
    ws = np.frombuffer(data, dtype=np.uint8).reshape(len(idx), PAGE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # read-only WS bytes
        table = torch.from_numpy(ws).to("cuda")
    order_d = torch.from_numpy(order).to("cuda")
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    kernel_ms = cuda_ms(lambda: gather_pages(table, order_d), iters=5)
    block_d = gather_pages(table, order_d)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    block_cuda = block_d.cpu().numpy()
    d2h_s = time.perf_counter() - t0
    del table, block_d
    t0 = time.perf_counter()
    fuse_ws_block(pages, data, engine="cuda", device="cuda")
    cuda_s = time.perf_counter() - t0
    if not np.array_equal(block_np, block_cuda):
        raise AssertionError("cuda and numpy fuse engines disagree")
    res = {"phase": "fuse_engines", "ws_pages": len(idx), "ws_bytes": len(data),
           "numpy_s": numpy_s, "cuda_s": cuda_s, "cuda_h2d_s": h2d_s,
           "cuda_kernel_ms": kernel_ms, "cuda_d2h_s": d2h_s, "identical": True}
    emit(res)
    return res


# -- phase 5: fleet path -----------------------------------------------------

FLEET_NODES = 2
FLEET_WAIT_S = 900.0                 # bound on each wait for one request
# One slot per node: the burst's second request finds the owner busy
# (score w_owner + w_ws - w_load x 1/1 = 0) and goes to the other node,
# so each node serves one cold start; no node restores a group.
FLEET_ROUTER = dict(max_concurrency=1, max_instances_per_function=1,
                    queue_depth=8, batch_restore_limit=1)


class FleetClient:
    """The fleet as the load generators see a router (``submit`` and
    ``invoke``), keeping each invocation so its logits and node can be
    read, and bounding every wait by ``wait_s``."""

    def __init__(self, fleet, wait_s: float):
        self.fleet, self.wait_s, self.invs = fleet, wait_s, []

    def submit(self, name: str, batch: dict):
        import types
        inv = self.fleet.submit(name, batch)
        self.invs.append(inv)
        return types.SimpleNamespace(
            result=lambda timeout=None: inv.result(timeout or self.wait_s))

    def invoke(self, name: str, batch: dict):
        return self.submit(name, batch).result()


def phase_fleet_path(cfg, device: str, store: str, batch: dict, main_res: dict,
                     t_start: float) -> dict:
    """Two spawned child processes, one node each (``build_fleet(...,
    transport="socket")``), serve ``FUNCTION`` over the main path's store:
    register (snapshot and WS record exist, so nothing is built), warm the
    owner shard's L1 (``rebalance``), a two-wide cold burst through
    ``OpenLoopGenerator`` -- one REAP cold start on each node, the
    non-owner's WS fetched from the owner across the process boundary --
    then three warm requests through ``ClosedLoopGenerator``.  Cold and
    warm logits are held bitwise to the main path's, the non-owner must
    show a remote fetch with bytes on the wire, and each child's
    ``flash_attention`` launches must be n_layers per forward it served.
    Returns the children's launch counts, summed."""
    import torch
    from repro_torch.cluster import ScheduleConfig, build_fleet
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serving import (ClosedLoopGenerator, OpenLoopGenerator,
                                     RouterConfig, ServeConfig, uniform_trace)
    from repro_torch.telemetry import StatsSnapshotter

    def line(**kw):
        emit({"phase": "fleet_path", "t": time.perf_counter() - t_start, **kw})
    config = ServeConfig(device=device, transport="socket",
                         router=RouterConfig(**FLEET_ROUTER))
    pids: list[int] = []
    with host_peak({}, pids=pids) as peak:
        t0 = time.perf_counter()
        fleet = build_fleet(FLEET_NODES, store, config=config,
                            cfg=ScheduleConfig(seed=SEED))
        try:
            pids += [n._proc.pid for n in fleet.nodes.values()]
            # answers once every child has its node and page server; a child
            # that died (no usable card, say) is missing from it
            up = sorted(fleet.stats()["nodes"])
            line(step="spawn", nodes=up, seconds=time.perf_counter() - t0)
            if up != sorted(fleet.nodes):
                raise AssertionError(f"node processes up: {up} of {sorted(fleet.nodes)}")
            t0 = time.perf_counter()
            fleet.register(FUNCTION, cfg, seed=SEED, warmup_batch=batch)
            line(step="register", seconds=time.perf_counter() - t0)
            t0 = time.perf_counter()
            warmed = fleet.rebalance()
            owner = fleet.ring.owner(FUNCTION)
            line(step="rebalance", seconds=time.perf_counter() - t0, owner=owner,
                 owners_warmed=warmed[FUNCTION])
            # counts from here on: launches (parent and children), transport
            fleet.reset_stats()
            reset_launches()
            client = FleetClient(fleet, FLEET_WAIT_S)
            t0 = time.perf_counter()
            OpenLoopGenerator(client, uniform_trace(2, 0.0, [FUNCTION], seed=SEED),
                              lambda ev: batch).run()
            line(step="cold_burst", seconds=time.perf_counter() - t0)
            t0 = time.perf_counter()
            ClosedLoopGenerator(client, uniform_trace(3, 0.0, [FUNCTION], seed=SEED),
                                lambda ev: batch, n_clients=1).run()
            line(step="warm_requests", seconds=time.perf_counter() - t0)
            stats = fleet.stats()
            snap = StatsSnapshotter(path=None)
            snap.add_source("fleet", lambda: stats)
            line(step="snapshot", sample=snap.sample())
        finally:
            fleet.close()
    parent = dict(LAUNCHES)
    served: dict[str, int] = {}
    shape = (*REQUEST, cfg.vocab)
    for i, inv in enumerate(client.invs):
        logits, rep = inv.result(FLEET_WAIT_S)
        node = inv.node_ids[-1]
        served[node] = served.get(node, 0) + 1
        label = f"cold_{i}" if i < 2 else f"warm_{i - 2}"
        line(step=label, node=node, **split(rep))
        check_logits(f"fleet {label}", logits, shape)
        want = main_res["cold"] if i < 2 else main_res["warm"]
        if not torch.equal(logits, want):
            raise AssertionError(f"fleet {label} logits (node {node}) != the main "
                                 f"path's {'single-cold' if i < 2 else 'warm'} logits")
        if i < 2 and rep.n_prefetched_pages != main_res["ws_pages"]:
            raise AssertionError(f"fleet {label} on {node} was not a REAP cold start")
    cold_nodes = sorted(inv.node_ids[-1] for inv in client.invs[:2])
    if cold_nodes != sorted(fleet.nodes):
        raise AssertionError(f"cold starts on {cold_nodes}: want one on each node")
    launches: dict[str, int] = {}
    for node, ns in stats["nodes"].items():
        tr = ns["transport"]
        plane = ("shm" if tr.get("shm_bytes") or tr["shm_responses"] else
                 "inline" if tr.get("inline_bytes") or tr["inline_responses"] else None)
        line(step="transport", node=node, owner=node == owner, plane=plane,
             **{k: tr.get(k) for k in ("wire_tx_bytes", "wire_rx_bytes", "shm_bytes",
                                       "inline_bytes", "remote_fetches", "origin_reads",
                                       "dead_owner_fallbacks", "chunks_served")},
             fetch_rtt_p50_s=tr["fetch_rtt_s"]["p50"],
             fetch_rtt_p95_s=tr["fetch_rtt_s"]["p95"],
             fetch_wait_p50_s=tr["fetch_wait_s"]["p50"],
             fetch_wait_p95_s=tr["fetch_wait_s"]["p95"],
             serve_prep_p50_s=tr["serve_prep_s"]["p50"],
             serve_prep_p95_s=tr["serve_prep_s"]["p95"])
        if node != owner and not (tr["remote_fetches"] >= 1 and tr["wire_rx_bytes"] > 0):
            raise AssertionError(f"non-owner {node} fetched no WS across the process "
                                 f"boundary: {tr}")
        got = ns["kernel_launches"]
        line(step="launch_counts", node=node, forwards=served.get(node, 0),
             kernel_launches=got)
        if got["flash_attention"] != cfg.n_layers * served.get(node, 0):
            raise AssertionError(f"{node}: flash_attention launched "
                                 f"{got['flash_attention']} times, want {cfg.n_layers} "
                                 f"x {served.get(node, 0)} forwards")
        for k, n in got.items():
            launches[k] = launches.get(k, 0) + n
    if any(parent.values()):
        raise AssertionError(f"the parent launched kernels in the fleet path: {parent}")
    line(step="done", host_rss_sum_peak_gb=peak["host_peak_gb"],
         host_rss_sum_start_gb=peak["host_start_gb"],
         host_used_peak_gb=peak["host_used_peak_gb"],
         host_used_start_gb=peak["host_used_start_gb"],
         cold_eq_main_single_cold=True, warm_eq_main_warm=True)
    return launches


# -- phase 6: decode paths ---------------------------------------------------

DEVICE = "cuda"
DECODE_BATCH, PROMPT, DECODE_STEPS, INT8_STEPS, F32_STEPS = 4, 1024, 32, 8, 8
# Logits through the kernels vs through the plain versions: four bfloat16
# ulps at the logits' largest magnitude, LOGIT_ATOL's reason made exact
# for logits that may pass 8 over 4 x 1056 positions.  Decode (and
# prefill) logits vs the teacher-forced forward over the same tokens: the
# step's attention runs the decode kernel over the cache where the forward
# runs flash attention over the sequence, the Mamba state is carried by
# one-step scans where the forward scans chunks, and the matmuls see other
# shapes; each side is within four ulps of an exact computation, so eight.
PLAIN_ULPS, TEACHER_ULPS = 4, 8
# An int8 cache adds its grid: each K/V element moves by up to amax/254 of
# its (token, head) row.  On the CPU at 16 layers (d_model 256) it moved
# decode logits by 1.1% (olmo-1b) and 2.2% (zamba2-1.2b) of their largest
# magnitude; twice the larger.
INT8_REL = 0.04
# zamba2-1.2b with random weights amplifies a one-ulp difference anywhere
# in its 38 Mamba2 layers far past any rounding bound in bfloat16:
# tests/test_torch_hybrid.py::test_zamba2_bf16_amplifies_a_rounding_nudge
# scales every SSD output by 1 + 1e-6 at d_model 512 and 38 layers, which
# moves bfloat16 logits by more than PLAIN_ULPS ulps and float32 ones by
# under 1e-3 of their magnitude.  So its bfloat16 run is held to its launch
# counts, finite logits and each kernel call against its plain version on
# the run's own inputs (``kernels_held_to_plain``), and a float32 twin
# (params and caches in float32) is held to the teacher-forced forward and
# to the plain versions within F32_ATOL[family]: ten times the larger of
# the H100's readings for its function (zamba2-1.2b 0.00077 against the
# forward, 0.00018 against plain; rwkv6-7b 9.2e-5 and 7.1e-5).
# rwkv6-7b in bfloat16 moves less, but past PLAIN_ULPS at full width (8
# ulps between the kernel and plain runs on the H100):
# tests/test_torch_rwkv.py::test_rwkv6_bf16_amplifies_a_rounding_nudge
# shows the same nudge moving bfloat16 logits by more than four ulps at
# d_model 1536 and 32 layers, and float32 ones by under 1e-3; it is held
# the same way, through its float32 twin (30 GB of params).
F32_ATOL = {"hybrid": 0.01, "rwkv": 1e-3}       # zamba2-1.2b, rwkv6-7b
# Kernel calls held to their plain versions on the model's inputs:
# bfloat16 outputs within KERNEL_ULPS ulps at their largest magnitude,
# float32 ones within the given tolerance, scaled by that magnitude where
# it passes 1.  B3, B4 and B6 take their kernel checks' tolerances.  B5's
# outputs reach ~220 at full width, where the JAX test's 1e-3 would allow
# 0.22: it takes ten times its H100 reading instead (worst error 1.16e-6 of
# the output's largest magnitude, over the bf16 and float32 runs).
# The device kernels each wrapper launches, by fragments of their names
# in a profiler trace (csrc/*.cu).
DEVICE_KERNELS = {"flash_attention": ("flash_fwd",),
                  "decode_attention": ("decode_split", "decode_combine"),
                  "ssd_scan": ("ssd_chunks", "ssd_step"),
                  "wkv6_scan": ("wkv6_chunks", "wkv6_steps")}
F32_KERNEL_ATOL = {"flash_attention": FLASH_ATOL["float32"],
                   "decode_attention": DECODE_ATOL["float32"], "ssd_scan": SSD_ATOL,
                   "wkv6_scan": 1.2e-5}


def attention_layers(cfg) -> int:
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers if cfg.family == "dense" else 0


def mamba_layers(cfg) -> int:
    return cfg.n_layers if cfg.family == "hybrid" else 0


def rwkv_layers(cfg) -> int:
    return cfg.n_layers if cfg.family == "rwkv" else 0


@contextlib.contextmanager
def kernels_held_to_plain():
    """Within the block, each call the models make to B3, B4, B5 or B6 also
    runs the kernel's plain version on the same inputs (before the caller
    writes any state in place).  Yields ``{kernel: {"calls", "max_abs_err",
    "worst_err_over_atol"}}``, filled as the calls come."""
    import torch
    from repro_torch.kernels.decode_attention import gqa_decode_ref
    from repro_torch.kernels.flash_attention import mha_ref
    from repro_torch.kernels.mamba2_scan import ssd_scan_ref
    from repro_torch.kernels.rwkv6_scan import wkv6_ref
    from repro_torch.models import mamba2, rwkv6
    from repro_torch.nn import layers
    seen: dict[str, dict] = {}
    sites = [(layers, "mha", mha_ref, "flash_attention"),
             (layers, "gqa_decode", gqa_decode_ref, "decode_attention"),
             (mamba2, "ssd_scan", ssd_scan_ref, "ssd_scan"),
             (rwkv6, "wkv6", wkv6_ref, "wkv6_scan")]

    def held(kernel, plain, name):
        def call(*args, **kw):
            out = kernel(*args, **kw)
            want = plain(*args, **kw)
            rec = seen.setdefault(name, {"calls": 0, "max_abs_err": 0.0,
                                         "worst_err_over_atol": 0.0})
            rec["calls"] += 1
            pairs = zip(out, want) if isinstance(out, tuple) else [(out, want)]
            for o, w in pairs:
                w = w.float()
                err = float((o.float() - w).abs().max())
                atol = (KERNEL_ULPS * bf16_ulp(w) if o.dtype == torch.bfloat16 else
                        F32_KERNEL_ATOL[name] * max(1.0, float(w.abs().max())))
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                rec["worst_err_over_atol"] = max(rec["worst_err_over_atol"],
                                                 err / atol if atol else float(err > 0))
            return out
        return call
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _, _ in sites]
    for mod, attr, plain, name in sites:
        setattr(mod, attr, held(getattr(mod, attr), plain, name))
    try:
        yield seen
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def float32_tree(tree):
    """``tree`` with every floating tensor in float32 (int8 stays)."""
    if isinstance(tree, dict):
        return {k: float32_tree(v) for k, v in tree.items()}
    return tree.float() if tree.is_floating_point() else tree


def generate(cfg, params, prompt, n_steps: int, *, plain: bool = False,
             forced=None, float32: bool = False) -> dict:
    """Prefill ``prompt`` into a fresh cache, then ``n_steps`` decode steps:
    greedy, or fed ``forced`` (B, n_steps) tokens.  Returns each step's
    logits (prefill first), the tokens fed, seconds, and the cache."""
    import torch
    from repro_torch.launch import steps
    B = prompt.shape[0]
    cache = steps.init_cache(cfg, B, prompt.shape[1] + n_steps, DEVICE)
    if float32:
        cache = float32_tree(cache)
    prefill = steps.build_prefill_step(cfg)
    decode = steps.build_decode_step(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": prompt}, cache, plain=plain)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    out, fed = [logits[:, -1].float()], []
    t0 = time.perf_counter()
    for i in range(n_steps):
        tok = (logits[:, -1].argmax(-1, keepdim=True) if forced is None
               else forced[:, i:i + 1])
        fed.append(tok)
        logits, cache = decode(params, cache, {"tokens": tok}, prompt.shape[1] + i,
                               plain=plain)
        out.append(logits[:, -1].float())
    torch.cuda.synchronize()
    decode_s = (time.perf_counter() - t0) / max(n_steps, 1)
    return {"logits": torch.stack(out, 1), "fed": torch.cat(fed, 1),
            "prefill_s": prefill_s, "decode_step_s": decode_s, "cache": cache}


def run_decode_path(label: str, cfg, params, n_steps: int, t_start: float, *,
                    float32: bool = False, held: bool = True) -> dict:
    """One decode path: the kernel run (its launches counted), the teacher-
    forced forward, and the run through the plain versions on the same
    tokens.  ``float32`` casts params and cache to float32; ``held`` holds
    the logits to the forward and the plain run.  Raises on any failed
    check; returns the emitted line."""
    import numpy as np
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import steps
    rng = np.random.default_rng(SEED)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (DECODE_BATCH, PROMPT),
                                           dtype=np.int32)).to(DEVICE)
    if float32:
        params = float32_tree(params)
    reset_launches()
    run = generate(cfg, params, prompt, n_steps, float32=float32)
    tokens = torch.cat([prompt, run["fed"].to(prompt.dtype)], 1)
    t0 = time.perf_counter()
    full = steps.build_forward(cfg)(params, {"tokens": tokens})
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    # one more decode step of the last token and more prefills, traced
    # outside the count: they rewrite the same cache rows (Mamba states move
    # on, unused after)
    cache, decode = run.pop("cache"), steps.build_decode_step(cfg)
    last = {"tokens": run["fed"][:, -1:]}
    step_profile = profile_forward(
        lambda: decode(params, cache, last, PROMPT + n_steps - 1),
        kernels={k: DEVICE_KERNELS[k] for k in ("decode_attention", "ssd_scan",
                                                "wkv6_scan")})
    prefill_profile = profile_forward(
        lambda: steps.build_prefill_step(cfg)(params, {"tokens": prompt}, cache),
        iters=2, kernels={k: DEVICE_KERNELS[k] for k in ("flash_attention", "ssd_scan",
                                                         "wkv6_scan")})
    del cache
    # one prefill and one decode step more, each kernel call held to its
    # plain version on the same inputs (outside the count)
    with kernels_held_to_plain() as per_call:
        generate(cfg, params, prompt, 1, forced=run["fed"], float32=float32)
    want_calls = {"flash_attention": attention_layers(cfg),
                  "decode_attention": attention_layers(cfg),
                  "ssd_scan": 2 * mamba_layers(cfg), "wkv6_scan": 2 * rwkv_layers(cfg)}
    calls = {k: n for k, n in want_calls.items() if n}
    if {k: r["calls"] for k, r in per_call.items()} != calls:
        raise AssertionError(f"{label}: held kernel calls {per_call}, want {calls}")
    want = {"flash_attention": attention_layers(cfg) * 2,          # prefill + forward
            "decode_attention": attention_layers(cfg) * n_steps,
            "ssd_scan": mamba_layers(cfg) * (1 + n_steps + 1),    # prefill, steps, forward
            "wkv6_scan": rwkv_layers(cfg) * (1 + n_steps + 1),
            "gather_pages": 0, "scatter_pages": 0}
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, want {want}")
    logits = run["logits"]                                     # (B, 1 + steps, vocab)
    shape = (DECODE_BATCH, 1 + n_steps, cfg.vocab)
    check_logits(label, logits, shape)
    teacher = full[:, PROMPT - 1:PROMPT + n_steps].float()
    teacher_err = float((logits - teacher).abs().max())
    atol = TEACHER_ULPS * bf16_ulp(teacher)
    if cfg.kv_cache_dtype == "int8":
        atol += INT8_REL * float(teacher.abs().max())
    del full, teacher
    plain = generate(cfg, params, prompt, n_steps, plain=True, forced=run["fed"],
                     float32=float32)
    del plain["cache"]
    plain_err = float((logits - plain["logits"]).abs().max())
    plain_atol = PLAIN_ULPS * bf16_ulp(plain["logits"])
    if float32:
        atol = plain_atol = F32_ATOL[cfg.family]
    if not held:
        atol = plain_atol = None
    res = {"phase": "decode_path", "path": label, "t": time.perf_counter() - t_start,
           "function": cfg.name, "kv_cache_dtype": cfg.kv_cache_dtype,
           "dtype": "float32" if float32 else cfg.dtype,
           "batch": DECODE_BATCH, "prompt": PROMPT, "decode_steps": n_steps,
           "prefill_s": run["prefill_s"], "decode_step_s": run["decode_step_s"],
           "forward_s": forward_s, "plain_prefill_s": plain["prefill_s"],
           "plain_decode_step_s": plain["decode_step_s"],
           "teacher_forced_max_abs": teacher_err, "teacher_atol": atol,
           "kernel_vs_plain_max_abs": plain_err, "plain_atol": plain_atol,
           "max_abs_logit": float(logits.abs().max()),
           "logits_finite": True, "launches": launches,
           "kernel_calls_vs_plain": per_call,
           "decode_step_profile": step_profile, "prefill_profile": prefill_profile}
    emit(res)
    if held and (teacher_err > atol or plain_err > plain_atol):
        raise AssertionError(f"{label}: teacher-forced err {teacher_err} (atol {atol}), "
                             f"kernel vs plain {plain_err} (atol {plain_atol})")
    off = {k: r for k, r in per_call.items() if r["worst_err_over_atol"] > 1}
    if off:
        raise AssertionError(f"{label}: kernel calls differ from their plain "
                             f"versions on the model's inputs: {off}")
    return res


def phase_decode_paths(t_start: float) -> dict:
    """olmo-1b with a bfloat16 and an int8 KV cache, then zamba2-1.2b and
    rwkv6-7b each in bfloat16 and as a float32 twin, at full width and
    depth from numpy seed 0.  Returns launches summed over the paths."""
    import dataclasses

    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.launch import steps
    total: dict[str, int] = {}
    # (label, KV cache dtype, steps, float32 twin, logits held)
    for function, paths in (
            ("olmo-1b", (("olmo-1b", "bfloat16", DECODE_STEPS, False, True),
                         ("olmo-1b/int8", "int8", INT8_STEPS, False, True))),
            ("zamba2-1.2b", (("zamba2-1.2b", "bfloat16", DECODE_STEPS, False, False),
                             ("zamba2-1.2b/f32", "bfloat16", F32_STEPS, True, True))),
            ("rwkv6-7b", (("rwkv6-7b", "bfloat16", DECODE_STEPS, False, False),
                          ("rwkv6-7b/f32", "bfloat16", F32_STEPS, True, True)))):
        t0 = time.perf_counter()
        with host_peak({"phase": "decode_path", "function": function,
                        "step": "init_params"}) as line:
            params = steps.init_params(ARCHS[function], SEED, DEVICE)
            torch.cuda.synchronize()
        emit({**line, "seconds": time.perf_counter() - t0,
              "params": sum(t.numel() for t in _leaves(params))})
        for label, kvd, n_steps, float32, held in paths:
            cfg = dataclasses.replace(ARCHS[function], kv_cache_dtype=kvd)
            res = run_decode_path(label, cfg, params, n_steps, t_start,
                                  float32=float32, held=held)
            for k, n in res["launches"].items():
                total[k] = total.get(k, 0) + n
        del params
        torch.cuda.empty_cache()
    return total


@contextlib.contextmanager
def host_peak(out: dict, every_s: float = 0.02, pids: list | None = None):
    """Samples the process's resident set (``/proc/self/statm``) every
    ``every_s`` seconds within the block and sets ``out["host_start_gb"]``
    and ``out["host_peak_gb"]`` to the first and the largest sample (None
    where the host offers no statm).  With ``pids`` (a list the block may
    fill), a sample is the sum over this process and those, so pages two
    of them share (shared memory, the page cache) count once for each;
    ``out["host_used_start_gb"]`` and ``out["host_used_peak_gb"]`` then
    also give the whole host's memory in use (``/proc/meminfo``'s MemTotal
    less MemAvailable), where a shared page counts once."""
    import threading
    page, seen, used, stop = os.sysconf("SC_PAGE_SIZE"), [], [], threading.Event()

    def rss(pid) -> int:
        with open(f"/proc/{pid}/statm") as f:
            return int(f.read().split()[1]) * page

    def in_use() -> int:
        kb = {}
        with open("/proc/meminfo") as f:
            for ln in f:
                key, val = ln.split(":", 1)
                kb[key] = int(val.split()[0])
        return (kb["MemTotal"] - kb["MemAvailable"]) * 1024

    def sample():
        while True:
            try:
                total = rss("self")
            except (OSError, ValueError, IndexError):
                return
            for pid in list(pids or ()):
                try:
                    total += rss(pid)
                except (OSError, ValueError, IndexError):
                    pass                 # a child not started yet or gone
            seen.append(total)
            if pids is not None:
                try:
                    used.append(in_use())
                except (OSError, ValueError, KeyError):
                    pass
            if stop.wait(every_s):
                return
    t = threading.Thread(target=sample, daemon=True)
    t.start()
    try:
        yield out
    finally:
        stop.set()
        t.join()
        out["host_start_gb"] = seen[0] / 1e9 if seen else None
        out["host_peak_gb"] = max(seen) / 1e9 if seen else None
        if pids is not None:
            out["host_used_start_gb"] = used[0] / 1e9 if used else None
            out["host_used_peak_gb"] = max(used) / 1e9 if used else None


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def kernel_table(rows: dict, launches: dict) -> list[dict]:
    src, tpu = "src/repro_torch/csrc/", "src/repro/kernels/"
    meta = {                         # the port's source, the TPU kernel's pallas_call
        "gather_pages": (src + "page_gather.cu", tpu + "page_gather/kernel.py:43"),
        "scatter_pages": (src + "page_gather.cu", tpu + "page_gather/kernel.py:75"),
        "flash_attention": (src + "flash_attention.cu",
                            tpu + "flash_attention/kernel.py:73"),
        "decode_attention": (src + "decode_attention.cu",
                             tpu + "decode_attention/kernel.py:87"),
        "ssd_scan": (src + "mamba2_scan.cu", tpu + "mamba2_scan/kernel.py:71"),
        "wkv6_scan": (src + "rwkv6_scan.cu", tpu + "rwkv6_scan/kernel.py:80"),
    }
    out = []
    for name, (source, replaces) in meta.items():
        r = rows[name]
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                    # device times (profiler): event times of short kernels
                    # carry the host's launch path
                    "device_ms": r.get("kernel_device_ms"),
                    "library_device_ms": r.get("library_device_ms")})
    return out


def main() -> int:
    import shutil
    import tempfile

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no usable CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import ARCHS    # fails here without the sources
    from repro_torch.kernels import LAUNCHES, reset_launches
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = phase_environment()
    phase_build()
    cfg = ARCHS[FUNCTION]             # full width and full depth: no cut
    batch = make_request(cfg, SEED)
    ws_pages = expected_ws_pages(cfg, batch)
    rows = phase_kernel_checks(ws_pages)
    emit({"phase": "main_path", "t": time.perf_counter() - t_start,
          "function": FUNCTION, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "request": list(REQUEST), "expected_ws_pages": ws_pages})
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    store = tempfile.mkdtemp(prefix="smoke_store_", dir=os.path.join(ROOT, "build"))
    try:
        reset_launches()
        main_res = run_main_path(cfg, "cuda", store, batch, t_start)
        launches = dict(LAUNCHES)
        if main_res["ws_pages"] != ws_pages:
            raise AssertionError(f"WS of {main_res['ws_pages']} pages, "
                                 f"expected {ws_pages}")
        n_forwards = main_res["forwards"]
        if launches["gather_pages"] < 1:
            raise AssertionError("the group restore launched no gather_pages")
        if launches["flash_attention"] != cfg.n_layers * n_forwards:
            raise AssertionError(f"flash_attention launched "
                                 f"{launches['flash_attention']} times, want "
                                 f"{cfg.n_layers} x {n_forwards} forwards")
        emit({"phase": "launch_counts", "path": "serving", "kernel_launches": launches,
              "forwards": n_forwards})
        phase_fuse_engines(main_res["base"])
        fleet_launches = phase_fleet_path(cfg, "cuda", store, batch, main_res, t_start)
        emit({"phase": "launch_counts", "path": "fleet", "kernel_launches": fleet_launches})
    finally:
        shutil.rmtree(store, ignore_errors=True)
    torch.cuda.empty_cache()
    decode_launches = phase_decode_paths(t_start)
    emit({"phase": "launch_counts", "path": "decode", "kernel_launches": decode_launches})
    launches = {k: n + fleet_launches.get(k, 0) + decode_launches.get(k, 0)
                for k, n in launches.items()}
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "flash_library_kernels": rows["flash_attention"]["library_kernels"]})
    print(env["nvidia_smi"], flush=True)
    emit({"kernels": kernel_table(rows, launches)})
    emit({"ok": True, "device": {"platform": "gpu", "kind": env["device"],
                                 "count": env["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
