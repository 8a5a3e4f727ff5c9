#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each (any failure raises and exits non-zero):

1. environment: the card, its power limit (``nvidia-smi``) and versions;
2. build: every kernel of ``src/repro_torch/csrc`` compiled with ``nvcc``
   for ``sm_90a`` (into ``build/repro_torch/``), then the scan kernels'
   and B3's backward kernels' registers, shared memory, spills and
   tensor-core instructions (the bf16 backward's must have some);
3. kernel checks: each kernel against its plain PyTorch version on the
   card at the main path's shapes, with its time, the plain version's,
   one library call's (a yardstick the port never calls) and its bound;
   B3's backward at olmo-1b's training shape (bf16 and f32), pixtral's
   GQA shape and seamless's bidirectional one, and B6's and B5's
   backward at zamba2-1.2b's and rwkv6-7b's training shapes (each split
   by the device kernels it launches) and two small float32 shapes each,
   and both at ROADMAP C4's strong decays, every backward also called
   twice and held bitwise equal;
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
5b. examples: ``examples/torch_quickstart.py`` (qwen2-7b SMOKE: record,
   warm, REAP cold), ``torch_serve_fleet.py`` (all ten SMOKE functions
   recorded, scaled to zero, and a 3 s Poisson trace replayed through
   ``Router`` with 8 slots, reactive and under ``PrewarmPolicy``) and
   ``torch_train_fault_tolerant.py`` (olmo-1b SMOKE, 200 steps preempted
   at 100 and restarted by REAP restore), each through its ``run`` on
   the card, in its own store, held to its own exit conditions and to
   exact launch counts;
6. MoE invocation: deepseek-moe-16b at full width and 3 layers, its
   snapshot built, then one invocation per request on a fresh arena, the
   executor routing each group on the true activations and faulting only
   the routed experts' pages (held to the routed ids, to each other and
   to a warm forward);
7. decode paths through ``launch.steps``: full-width olmo-1b (bfloat16
   and int8 KV cache), qwen2-7b, zamba2-1.2b, rwkv6-7b and
   deepseek-moe-16b (8 of its 28 layers) (bfloat16, and a float32 twin
   of each), pixtral-12b (8 of its 40 layers, 1024 patch embeddings
   before the tokens) and seamless-m4t-medium (128 frames through the
   bidirectional encoder) prefill 4 x 1024 tokens and decode greedily,
   each step held to a teacher-forced forward and to a run through the
   plain versions (the bfloat16 zamba2, rwkv6 and deepseek runs excepted,
   and qwen2-7b's held to the forward only, its prefill to plain at 2
   and 7 layers: see ``F32_ATOL``; the MoE runs route as their kernel
   run did, ``RouteLog``), and each kernel call of a prefill and a
   decode step held to its plain version on the model's own inputs;
8. train path: full-width olmo-1b (bf16, AdamW, 4 x 1024 tokens of the
   ``launch.train`` corpus): one step's loss and gradients through the
   kernels held to the plain versions' (and a float32 twin of its first
   4 layers), exactly one B3 forward and one B3 backward per layer and
   step, a ``Trainer`` run preempted after step 4 and restarted by REAP
   restore of its step-3 checkpoint (0 faults, bitwise the saved
   tensors), its losses held to an uninterrupted run's, and the step's
   profile, checkpoint bytes, stage, write and restore seconds and the
   checkpoints' peak disk; then the distributed path on the step-3
   checkpoint: elastic restores onto {data: 2, 4, 8} and the 16 x 16
   production mesh (``restore_for_mesh``, bitwise the saved parameters),
   a ``Trainer`` step from the {data: 8} restore whose loss is bitwise the
   restarted run's, ``ef_psum`` over its gradients on a one-rank NCCL
   group (bitwise the local compression) and the olmo-1b x train_4k
   dry-run cell (``launch.dryrun``, fake tensors); then zamba2-1.2b
   (full depth) and rwkv6-7b (8 of its 32 layers) train at full width:
   a float32 twin's step held to the plain versions', the bf16 step
   finite (zamba2's within its gate, and again with each half of B6
   plain), one step with exactly a B6 (B5) forward and backward per layer
   and B3's per shared-block application, the s per step and a traced
   step;
9. the launch counts of each path (counts set to 0 just before it, read
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
FLASH_CASES = [                      # (B, S, H, KV, D, dtype, causal)
    (2, 256, 4, 2, 64, "float32", True),   # the four shapes of tests/test_kernels.py
    (1, 128, 8, 8, 128, "float32", True),
    (2, 384, 6, 2, 80, "float32", True),
    (1, 256, 4, 1, 64, "bfloat16", True),
    (1, 64, 16, 16, 128, "bfloat16", True),     # olmo-1b, the serving request
    (1, 2048, 16, 16, 128, "bfloat16", True),   # olmo-1b, a long prompt
    (4, 1024, 16, 16, 128, "bfloat16", True),   # olmo-1b prefill: the kernel table's row
    (4, 1056, 16, 16, 128, "bfloat16", True),   # olmo-1b teacher-forced forward (ragged)
    (4, 1024, 32, 32, 64, "bfloat16", True),    # zamba2-1.2b prefill
    (4, 1024, 28, 4, 128, "bfloat16", True),    # qwen2-7b prefill: GQA with G = 7
    (4, 128, 16, 16, 64, "bfloat16", False),    # seamless-m4t-medium's encoder
    (4, 128, 16, 16, 64, "float32", False),     # (bidirectional), bf16 and f32
]
FLASH_ROW = (4, 1024, 16, 16, 128)      # B3's row of the kernel table
# Cases also held within KERNEL_ULPS bfloat16 ulps of the plain version at
# its largest magnitude (FLASH_ATOL is absolute): the first launches at a
# group size that is not a power of two
FLASH_ULP_GATED = {(4, 1024, 28, 4, 128, "bfloat16", True)}
FLASH_ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
FLASH_BWD_CASES = [                  # (B, S, H, KV, D, dtype, causal)
    (4, 1024, 16, 16, 128, "bfloat16", True),   # olmo-1b training: the table's row
    (4, 1024, 16, 16, 128, "float32", True),    # its float32 twin
    (4, 2048, 32, 8, 128, "bfloat16", True),    # pixtral-12b (GQA, 1024 patches + 1024)
    (4, 128, 16, 16, 64, "bfloat16", False),    # seamless-m4t-medium's encoder
]
# B3's backward against its plain version on the same inputs (the
# kernel's own output and LSE).  The plain version computes in float32.
# The kernel's bfloat16 route runs its products on the tensor cores: the
# products of bfloat16 inputs are exact and summed in float32, and P and
# dS enter dV, dK and dQ as three bfloat16 parts (at least float32's 24
# bits); its float32 route computes in float32 on the CUDA cores.  Each
# rounds every output once to the inputs' dtype.  So a bfloat16 output is
# within half an ulp of the float32 result, and a different order of
# summation flips that rounding by one: KERNEL_ULPS ulps at each output's
# largest magnitude, as the forward's gate.  A float32 output differs only
# by the order of its sums: the forward check's 2e-5, scaled by the
# output's largest magnitude where it passes 1 (dK and dV sum over up to
# G * S query rows).
# B3's backward's device kernels, by fragments of their names
FLASH_BWD_KERNELS = {"delta": ("flash_bwd_delta",), "dkdv": ("flash_bwd_dkdv",),
                     "dq": ("flash_bwd_dq",)}
DECODE_CASES = [                     # (B, S, H, KV, D, dtype, kv_len or None = random)
    (2, 1024, 8, 2, 64, "float32", None),    # the three shapes of tests/test_kernels.py
    (1, 2048, 4, 4, 128, "float32", None),
    (3, 512, 16, 2, 80, "float32", None),
    (4, 1056, 16, 16, 128, "bfloat16", 1056),   # olmo-1b, the last decode step
    (4, 1056, 32, 32, 64, "bfloat16", 1056),    # zamba2-1.2b, the last decode step
    (4, 1056, 28, 4, 128, "bfloat16", 1056),    # qwen2-7b, the last decode step (G = 7)
    (4, 132, 16, 16, 64, "bfloat16", 128),      # seamless-m4t-medium's cross cache
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
SSD_BWD_CASES = [                    # (Bz, L, H, P, N, x dtype)
    (4, 1024, 64, 64, 64, "bfloat16"),       # zamba2-1.2b training: the table's row
    (2, 203, 4, 64, 32, "float32"),          # ragged L (not a multiple of 8)
    (1, 77, 2, 128, 16, "float32"),
]
WKV_BWD_CASES = [                    # (B, L, H, D, r/k/v dtype)
    (4, 1024, 64, 64, "bfloat16"),           # rwkv6-7b training: the table's row
    (2, 203, 4, 64, "float32"),              # ragged L
    (1, 77, 2, 32, "float32"),
]
# The scans' backward kernels against their oracles (``ssd_scan_bwd_ref``,
# ``wkv6_bwd_ref``, which walk the recurrence a step at a time in float32)
# on the same inputs, a nonzero initial state and final state cotangent.
# The kernels are chunk-parallel: their products run at split TF32 (22
# bits of each operand) and sum in other orders (over a chunk, the
# chunks, b and the heads): a float32 gradient within the forward
# kernel's bound relative to its largest magnitude (B6's SSD_ATOL, B5's
# 1.2e-5 of F32_KERNEL_ATOL); a bfloat16 dx, dr, dk or dv is rounded once
# from float32, so KERNEL_ULPS ulps at its largest magnitude.  The same
# gates hold at ROADMAP C4's strong decays (SCAN_BWD_STRONG), where the
# gradients must also be finite.
SCAN_BWD_REL = {"ssd_scan_bwd": SSD_ATOL, "wkv6_scan_bwd": 1.2e-5}
# ROADMAP C4's inputs (tests/test_torch_scan_bwd.py): A = -100 over 64
# steps (A dt sums to about -500 a chunk), and log decays in [-30, -5]
SCAN_BWD_STRONG = {"ssd_scan_bwd": (1, 64, 2, 64, 16), "wkv6_scan_bwd": (1, 64, 2, 64)}
# the scans' backward kernels' device kernels, by the part each computes
SCAN_BWD_PARTS = {
    "ssd_scan_bwd": {"state_walk": r"ssd_bwd_walk<.*false>", "grad_walk": r"ssd_bwd_walk<.*true>",
                     "chunk_grads": r"ssd_bwd_chunk<", "ordered_sums": r"ssd_bwd_sum"},
    "wkv6_scan_bwd": {"state_walk": r"wkv6_bwd_walk<.*false>", "grad_walk": r"wkv6_bwd_walk<.*true>",
                      "chunk_grads": r"wkv6_bwd_chunk<", "ordered_sums": r"wkv6_bwd_sum"}}


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
    report = scan_kernel_report(build.build_dir(), libs)
    emit({"phase": "ptxas", "kernels": report})
    # B3's bfloat16 backward runs on the tensor cores (unknown without cuobjdump)
    scalar = [n for n, r in report.items()
              if "flash_bwd" in n and "_bf16" in n and r["hmma"] == 0]
    if scalar:
        raise AssertionError(f"no HMMA instruction in {scalar}")


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
    B6) and of B3's backward kernels from the build's ``-Xptxas -v`` logs,
    and its HMMA (tensor-core mma) instructions in the built code
    (``cuobjdump -sass``; None without the tool)."""
    import re
    seen: dict[str, dict] = {}
    for stem, only in (("mamba2_scan", ""), ("rwkv6_scan", ""),
                       ("flash_attention", "flash_bwd")):
        fn = None
        for ln in (out_dir / f"{stem}.log").read_text().splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            if m:
                fn = m.group(1) if only in m.group(1) else None
                if fn:
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


def check_flash(B: int, S: int, H: int, KV: int, D: int, dtype: str,
                causal: bool) -> dict:
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

    def kernel():
        return mha(q, k, v, causal=causal)

    def plain():
        return mha_ref(q, k, v, causal=causal)

    def library():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, enable_gqa=H != KV)
    out = kernel()
    ref = plain()
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    n_bytes = (q.numel() * 2 + k.numel() * 2) * q.element_size()
    # QK^T and PV: the causal half, or every pair
    n_ops = 4 * B * H * D * (S * (S + 1) // 2 if causal else S * S)
    b, by = bound_ms(n_bytes, n_ops, dtype)
    library_kernels, library_device_ms = device_profile(library)
    ulp = bf16_ulp(ref.float()) if dtype == "bfloat16" else None
    ulps = err / ulp if ulp else None
    ok = err <= FLASH_ATOL[dtype] and (
        (B, S, H, KV, D, dtype, causal) not in FLASH_ULP_GATED or ulps <= KERNEL_ULPS)
    return {"kernel": "flash_attention", "shape": [B, S, H, KV, D], "causal": causal,
            "dtype": dtype, "max_abs_err": err, "atol": FLASH_ATOL[dtype],
            "max_abs_out": float(ref.float().abs().max()), "err_bf16_ulps": ulps,
            "ok": ok,
            # outputs that differ from the plain version's at all (in bf16:
            # those whose rounding flipped)
            "differing_share": float((out != ref).float().mean()),
            "kernel_ms": cuda_ms(kernel, 50),
            "plain_ms": cuda_ms(plain, 20 if S <= 512 else 5),
            "library_ms": cuda_ms(library, 50),
            "kernel_device_ms": device_profile(kernel)[1],
            "library_kernels": library_kernels,
            "library_device_ms": library_device_ms,
            "bound_ms": b, "bound_by": by}


def check_flash_bwd(B: int, S: int, H: int, KV: int, D: int, dtype: str,
                    causal: bool) -> dict:
    """B3's backward kernel against ``flash_attention_bwd_ref`` on the
    kernel forward's own output and LSE, and a second kernel call against
    the first, byte for byte (``deterministic``).  ``plain_ms`` is the
    backward of autograd through ``mha_ref`` (its graph kept, the backward
    alone timed); ``library_ms`` the same of ``scaled_dot_product_attention``.
    The bound: q, k, v, o, dO and the LSE read once, dq, dk, dv written
    once, against five products (S and dP recomputed, dV, dK, dQ) over the
    causal half or every pair."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import mha_ref
    from repro_torch.kernels.flash_attention.ops import _forward, flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref
    rng = np.random.default_rng(S * 1000 + H + 7)
    tdt = getattr(torch, dtype)

    def r(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to("cuda", tdt)
    q, k, v, do = r(B, S, H, D), r(B, S, KV, D), r(B, S, KV, D), r(B, S, H, D)
    o, lse = _forward(q, k, v, causal, want_lse=True)

    def kernel():
        return flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    got = kernel()
    again = kernel()
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    # no atomics and a fixed order of sums: a second call gives the same bytes
    same_bytes = all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                     for a, b in zip(got, again))
    del again
    errs, atols = {}, {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        errs[name] = float((g.float() - w).abs().max())
        atols[name] = (KERNEL_ULPS * bf16_ulp(w) if dtype == "bfloat16" else
                       FLASH_ATOL["float32"] * max(1.0, float(w.abs().max())))
    del got, want
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    plain_out = mha_ref(*leaves, causal=causal)

    def plain():
        return torch.autograd.grad(plain_out, leaves, do, retain_graph=True)
    tl = [t.transpose(1, 2) for t in leaves]
    lib_out = F.scaled_dot_product_attention(*tl, is_causal=causal, enable_gqa=H != KV)

    def library():
        return torch.autograd.grad(lib_out, leaves, do.transpose(1, 2),
                                   retain_graph=True)
    big = S * H >= 2048 * 32
    ms = cuda_ms_in_turns({"kernel": kernel, "plain": plain, "library": library},
                          3 if big else 10)
    library_kernels, library_device_ms = device_profile(library, calls=3)
    item = q.element_size()
    n_bytes = (4 * q.numel() + 4 * k.numel()) * item + lse.numel() * 4
    n_ops = 5 * 2 * B * H * D * (S * (S + 1) // 2 if causal else S * S)
    b, by = bound_ms(n_bytes, n_ops, dtype)
    res = {"kernel": "flash_attention_bwd", "shape": [B, S, H, KV, D], "causal": causal,
           "dtype": dtype, "errors": errs, "atols": atols,
           "max_abs_err": max(errs.values()),
           "ok": all(errs[n] <= atols[n] for n in errs),
           "deterministic": same_bytes,
           "kernel_ms": ms["kernel"], "plain_ms": ms["plain"],
           "library_ms": ms["library"],
           "kernel_device_ms": device_profile(kernel, calls=3)[1],
           # the same call's device ms by kernel, from one traced call
           "kernel_device_ms_by_kernel": profile_forward(
               kernel, iters=3, kernels=FLASH_BWD_KERNELS)["kernel_device_ms"],
           "library_kernels": library_kernels, "library_device_ms": library_device_ms,
           "bound_ms": b, "bound_by": by}
    del plain_out, lib_out, leaves
    torch.cuda.empty_cache()
    return res


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


def device_ms_by_part(fn, parts: dict, calls: int = 3) -> dict:
    """Device milliseconds a call of ``fn`` by part: ``parts`` maps a part
    to a regular expression its device kernels' names match; a kernel
    matched by none goes to "other".  One trace of ``calls`` calls."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {part: 0.0 for part in parts}
    for e in device_spans(prof):
        part = next((p for p, rx in parts.items() if re.search(rx, e.name)), "other")
        out[part] = out.get(part, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / calls
    if not any(out.values()):
        raise RuntimeError("the profiler caught no device span")
    return out


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


def scan_bwd_report(name: str, names: tuple, kernel, oracle, leaves, outs, cotangents,
                    n_bytes: float, n_ops: float, iters: int) -> dict:
    """A scan's backward kernel against its oracle, twice (``deterministic``:
    the same bytes), with its time, its device time, the plain version's
    (autograd of the plain scan, its graph kept, the backward alone timed)
    and its bound at split TF32.  No single library call computes either
    gradient: library_ms is None."""
    import torch
    got = kernel()
    again = kernel()
    want = oracle()
    torch.cuda.synchronize()
    same_bytes = all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                     for a, b in zip(got, again))
    errs, atols = {}, {}
    for n, g, w in zip(names, got, want):
        w = w.float()
        errs[n] = float((g.float() - w).abs().max())
        atols[n] = (KERNEL_ULPS * bf16_ulp(w) if g.dtype == torch.bfloat16 else
                    SCAN_BWD_REL[name] * float(w.abs().max()))
    del got, again, want

    def plain():
        return torch.autograd.grad(outs, leaves, cotangents, retain_graph=True)
    ms = cuda_ms_in_turns({"kernel": kernel, "plain": plain}, iters)
    b, by = bound_ms(n_bytes, n_ops, "tf32")
    return {"kernel": name, "errors": errs, "atols": atols,
            "max_abs_err": max(errs.values()),
            "ok": all(errs[n] <= atols[n] for n in errs), "deterministic": same_bytes,
            "kernel_ms": ms["kernel"], "plain_ms": ms["plain"],
            "kernel_device_ms": device_profile(kernel, calls=3)[1],
            "kernel_device_ms_by_part": device_ms_by_part(kernel, SCAN_BWD_PARTS[name]),
            "library_ms": None, "bound_ms": b, "bound_by": by}


def check_scan_bwd_strong_decay() -> dict:
    """Both scans' backward kernels at ROADMAP C4's strong decays
    (``SCAN_BWD_STRONG``), float32: finite, within ``SCAN_BWD_REL`` of
    their oracles, two calls bitwise equal."""
    import numpy as np
    import torch
    from repro_torch.kernels.mamba2_scan import ssd_scan_bwd, ssd_scan_bwd_ref
    from repro_torch.kernels.rwkv6_scan import wkv6_bwd_ref, wkv6_scan_bwd
    rng = np.random.default_rng(64)

    def r(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale
                                ).to("cuda")
    Bz, L, H, P, N = SCAN_BWD_STRONG["ssd_scan_bwd"]
    ssd_args = (r(Bz, L, H, P), r(Bz, L, H, scale=0.1).abs(),
                torch.full((H,), -100.0, device="cuda"), r(Bz, L, N, scale=0.3),
                r(Bz, L, N, scale=0.3), r(Bz, H, N, P, scale=0.1), r(Bz, L, H, P),
                r(Bz, H, N, P))
    B, L, H, D = SCAN_BWD_STRONG["wkv6_scan_bwd"]
    logw = torch.from_numpy(rng.uniform(-30, -5, (B, L, H, D)).astype(np.float32)).to("cuda")
    wkv_args = (r(B, L, H, D), r(B, L, H, D, scale=0.3), r(B, L, H, D), logw,
                r(H, D, scale=0.2), r(B, H, D, D, scale=0.1), r(B, L, H, D), r(B, H, D, D))
    res = {"phase": "kernel_check", "kernel": "scan_bwd_strong_decay", "ok": True}
    for name, kernel, oracle, args, names in (
            ("ssd_scan_bwd", ssd_scan_bwd, ssd_scan_bwd_ref, ssd_args,
             ("dx", "ddt", "dA", "dB", "dC", "dh0")),
            ("wkv6_scan_bwd", wkv6_scan_bwd, wkv6_bwd_ref, wkv_args,
             ("dr", "dk", "dv", "dlogw", "du", "ds0"))):
        got, again, want = kernel(*args), kernel(*args), oracle(*args)
        torch.cuda.synchronize()
        rel = {n: float((g - w).abs().max() / w.abs().max()) for n, g, w in zip(names, got, want)}
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        same = all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                   for a, b in zip(got, again))
        ok = finite and same and max(rel.values()) <= SCAN_BWD_REL[name]
        res[name] = {"shape": list(args[0].shape), "rel_err": rel, "finite": finite,
                     "deterministic": same, "bound": SCAN_BWD_REL[name], "ok": ok}
        res["ok"] = res["ok"] and ok
    return res


def check_ssd_bwd(Bz: int, L: int, H: int, P: int, N: int, xdt: str) -> dict:
    """ssd_scan_bwd against ssd_scan_bwd_ref.  The bound: x, dt, A, B, C,
    h0, dy and dhT read once, dx, ddt, dA, dB, dC and dh0 written once,
    against the chunked form's products at the forward kernel's chunk: C
    B^T recomputed and its two gradients, M x's and C h's two gradients
    each, the chunk states recomputed and their update's two gradients,
    at split TF32 (three products a multiply-add; two where one operand is
    x in bfloat16)."""
    import numpy as np
    import torch
    from repro_torch.kernels.mamba2_scan import ssd_scan_bwd, ssd_scan_bwd_ref, ssd_scan_ref
    rng = np.random.default_rng(L * 10 + H + 1)

    def r(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale
                                ).to("cuda")
    x = r(Bz, L, H, P).to(getattr(torch, xdt))
    dt, A = r(Bz, L, H, scale=0.1).abs(), -r(H).abs()
    B, C, h0 = r(Bz, L, N, scale=0.3), r(Bz, L, N, scale=0.3), r(Bz, H, N, P, scale=0.1)
    dy, dhT = r(Bz, L, H, P), r(Bz, H, N, P)
    args = (x, dt, A, B, C, h0)
    leaves = [t.clone().requires_grad_(True) for t in args]
    outs = ssd_scan_ref(*leaves, chunk=128)
    ops = ssd_operations(Bz, L, H, P, N, SSD_KERNEL_CHUNK)
    px = 2 if xdt == "bfloat16" else 3
    n_ops = 9 * ops["CB"] + (px + 3) * ops["Mx"] + 6 * ops["Ch"] + (2 * px + 3) * ops["update"]
    n_bytes = (2 * x.numel() * x.element_size()
               + 4 * (2 * (dt.numel() + A.numel() + B.numel() + C.numel() + h0.numel())
                      + dy.numel() + dhT.numel()))
    res = scan_bwd_report(
        "ssd_scan_bwd", ("dx", "ddt", "dA", "dB", "dC", "dh0"),
        lambda: ssd_scan_bwd(*args, dy, dhT),
        lambda: ssd_scan_bwd_ref(*args, dy, dhT), leaves, outs, (dy, dhT),
        n_bytes, n_ops, 3 if L >= 1024 else 10)
    del leaves, outs
    torch.cuda.empty_cache()
    return {**res, "shape": [Bz, L, H, P, N], "x_dtype": xdt}


def check_wkv6_bwd(B: int, L: int, H: int, D: int, dt: str) -> dict:
    """wkv6_scan_bwd against wkv6_bwd_ref.  The bound: r, k, v, logw, u,
    s0, dy and dsT read once, dr, dk, dv, dlogw, du and ds0 written once,
    against the recurrence's multiply-adds a step and head (the state
    recomputed, dlogw, dk, dr, dv and dS's update: 6 D^2) at split TF32."""
    import numpy as np
    import torch
    from repro_torch.kernels.rwkv6_scan import wkv6_bwd_ref, wkv6_ref, wkv6_scan_bwd
    rng = np.random.default_rng(L * 10 + H + 1)

    def r(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale
                                ).to("cuda")
    tdt = getattr(torch, dt)
    rr, k, v = r(B, L, H, D).to(tdt), r(B, L, H, D, scale=0.3).to(tdt), r(B, L, H, D).to(tdt)
    logw = -r(B, L, H, D, scale=0.5).abs() - 0.05
    u, s0 = r(H, D, scale=0.2), r(B, H, D, D, scale=0.1)
    dy, dsT = r(B, L, H, D), r(B, H, D, D)
    args = (rr, k, v, logw, u, s0)
    leaves = [t.clone().requires_grad_(True) for t in args]
    outs = wkv6_ref(*leaves, chunk=32)
    n_bytes = (6 * rr.numel() * rr.element_size()
               + 4 * (3 * logw.numel() + 2 * u.numel() + 3 * s0.numel()))
    res = scan_bwd_report(
        "wkv6_scan_bwd", ("dr", "dk", "dv", "dlogw", "du", "ds0"),
        lambda: wkv6_scan_bwd(*args, dy, dsT),
        lambda: wkv6_bwd_ref(*args, dy, dsT), leaves, outs, (dy, dsT),
        n_bytes, 3 * 2 * 6 * B * L * H * D * D, 3 if L >= 1024 else 10)
    del leaves, outs
    torch.cuda.empty_cache()
    return {**res, "shape": [B, L, H, D], "rkv_dtype": dt}


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
                                 f"{res['max_abs_err']} > {res['atol']} (or "
                                 f"{res['err_bf16_ulps']} > {KERNEL_ULPS} ulps)")
        if case[:5] == FLASH_ROW and case[6]:
            rows["flash_attention"] = res
    for case in FLASH_BWD_CASES:
        res = check_flash_bwd(*case)
        emit({"phase": "kernel_check", **res})
        if not res["ok"]:
            raise AssertionError(f"flash_attention_bwd {case}: errors {res['errors']} "
                                 f"past {res['atols']}")
        if not res["deterministic"]:
            raise AssertionError(f"flash_attention_bwd {case}: two calls on the same "
                                 "inputs gave different bytes")
        if case == FLASH_BWD_CASES[0]:
            rows["flash_attention_bwd"] = res
    for fn, cases, name in ((check_ssd_bwd, SSD_BWD_CASES, "ssd_scan_bwd"),
                            (check_wkv6_bwd, WKV_BWD_CASES, "wkv6_scan_bwd")):
        for case in cases:
            res = fn(*case)
            emit({"phase": "kernel_check", **res})
            if not res["ok"]:
                raise AssertionError(f"{name} {case}: errors {res['errors']} past "
                                     f"{res['atols']}")
            if not res["deterministic"]:
                raise AssertionError(f"{name} {case}: two calls on the same inputs "
                                     "gave different bytes")
            if case == cases[0]:
                rows[name] = res
    res = check_scan_bwd_strong_decay()
    emit(res)
    if not res["ok"]:
        raise AssertionError(f"the scans' backwards at strong decay: {res}")
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


# -- phase 5b: the examples ----------------------------------------------------

# examples/torch_*.py, each at its run()'s defaults: the JAX examples' own
# sizes (SMOKE configs, the quickstart's default function, the fleet's 3 s
# trace), and 200 training steps preempted at 100
EXAMPLE_TRAIN_STEPS = 200
QUICK_FORWARDS = 4                   # deploy warm-up, record, warm, REAP cold


def forward_launches(forwards: dict, groups: int = 0) -> dict:
    """The launches of ``forwards`` ({SMOKE config: forwards run}) without
    a cache and of ``groups`` group restores: B3 ``flash_per_pass``, B6 one
    per Mamba layer and B5 one per RWKV layer each forward, B1 one per
    group (its fused WS gather), and no other kernel; with each sum
    written out."""
    want, terms = {"gather_pages": groups}, {"gather_pages": f"{groups} groups"}
    for kernel, per in (("flash_attention", flash_per_pass), ("ssd_scan", mamba_layers),
                        ("wkv6_scan", rwkv_layers)):
        parts = [(cfg.name, per(cfg), n) for cfg, n in forwards.items() if per(cfg)]
        want[kernel] = sum(p * n for _, p, n in parts)
        terms[kernel] = " + ".join(f"{p} x {n} ({name})" for name, p, n in parts) or "0"
    for kernel in ("decode_attention", "scatter_pages", "flash_attention_bwd",
                   "ssd_scan_bwd", "wkv6_scan_bwd"):
        want[kernel] = 0
    return {"want": want, "formula": terms}


@contextlib.contextmanager
def group_restores():
    """Yields a list that gets [size, monitor mode] of each group restore
    of more than one instance the serving layer makes while inside: one in
    ``prefetch`` mode fuses its WS once (B1), one that records fuses
    nothing."""
    from repro_torch.serving import orchestrator
    inner, groups = orchestrator.restore_group, []

    def counted(insts, **kw):
        out = inner(insts, **kw)
        if len(insts) > 1:
            groups.append([len(insts), insts[0].monitor.mode])
        return out
    orchestrator.restore_group = counted
    try:
        yield groups
    finally:
        orchestrator.restore_group = inner


def phase_examples_path(t_start: float) -> dict:
    """The port's three examples on the card, each through its ``run``:
    ``torch_quickstart`` (qwen2-7b SMOKE: record, warm, REAP cold),
    ``torch_serve_fleet`` (all ten SMOKE functions recorded, scaled to
    zero, and the 3 s Poisson trace replayed through ``Router`` with 8
    slots, reactive and under ``PrewarmPolicy``) and
    ``torch_train_fault_tolerant`` (olmo-1b SMOKE, 200 steps preempted at
    100, REAP restart, an uninterrupted run).  Gates: each example's own
    exit condition; every function served on the card; each example's
    launches exact (``forward_launches``: the forwards are the deploy
    warm-ups plus one per served request, and B1 runs once per group
    restore; training launches B3 forward and backward once per layer and
    step).  Stores and work directories
    under ``build/``, deleted after.  Returns the phase's launches."""
    import shutil
    import tempfile

    import torch
    from repro_torch.configs import ARCHS, SMOKES
    from repro_torch.kernels import LAUNCHES, reset_launches
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import torch_quickstart as quick
    import torch_serve_fleet as fleet
    import torch_train_fault_tolerant as train
    smoke_of = {cfg.name: cfg for cfg in SMOKES.values()}
    total: dict[str, int] = {}

    def log(*args):
        print(*args, file=sys.stderr, flush=True)

    def taken() -> dict:
        got = dict(LAUNCHES)
        reset_launches()
        for k, n in got.items():
            total[k] = total.get(k, 0) + n
        return got

    def line(**kw):
        emit({"phase": "examples_path", "t": time.perf_counter() - t_start, **kw})
    work = tempfile.mkdtemp(prefix="examples_", dir=os.path.join(ROOT, "build"))
    try:
        reset_launches()
        t0 = time.perf_counter()
        q = quick.run(store=os.path.join(work, "quick"), device=DEVICE)
        seconds = time.perf_counter() - t0
        got = taken()
        want = forward_launches({smoke_of[q["function"]]: QUICK_FORWARDS})
        same = torch.equal(q["record_logits"], q["reap_cold_logits"])
        line(example="torch_quickstart", seconds=seconds, function=q["function"],
             record=q["record"], warm=q["warm"], reap_cold=q["reap_cold"],
             ws_pages=q["ws_pages"], reap_cold_eq_record=same,
             launches=got, want_launches=want["want"], formula=want["formula"])
        if not same or q["warm"]["n_faults"]:
            raise AssertionError(f"torch_quickstart: REAP cold == record {same}, warm "
                                 f"faults {q['warm']['n_faults']}")
        if got != want["want"]:
            raise AssertionError(f"torch_quickstart: launches {got}, want {want['want']}")

        t0 = time.perf_counter()
        with group_restores() as groups:
            f = fleet.run(store=os.path.join(work, "fleet"), device=DEVICE, log=log)
        seconds = time.perf_counter() - t0
        got = taken()
        forwards = {SMOKES[n]: 2 + f["reactive"]["served_by_function"].get(n, 0)
                    + f["adaptive"]["served_by_function"].get(n, 0) for n in f["functions"]}
        want = forward_launches(forwards, sum(m == "prefetch" for _, m in groups))
        keys = ("arrivals", "served", "refused", "failed", "not_finite", "cold",
                "cold_fraction", "e2e_p50_s", "e2e_p95_s", "queue_p95_s", "ws_cache_hits",
                "prewarmed", "batched", "steady_state_cold", "steady_state_n",
                "served_by_function")
        line(example="torch_serve_fleet", seconds=seconds, record=f["record"],
             **{k: {x: f[k][x] for x in keys} for k in ("reactive", "adaptive")},
             ws_cache=f["ws_cache"], forwards={c.name: n for c, n in forwards.items()},
             group_restores=groups, launches=got, want_launches=want["want"], formula=want["formula"])
        bad = fleet.failures(f)
        if sorted(f["record"]) != sorted(ARCHS) or bad:
            raise AssertionError(f"torch_serve_fleet: served {sorted(f['record'])}; {bad}")
        if got != want["want"]:
            raise AssertionError(f"torch_serve_fleet: launches {got}, want {want['want']}")

        t0 = time.perf_counter()
        tr = train.run(steps=EXAMPLE_TRAIN_STEPS, workdir=os.path.join(work, "train"),
                       device=DEVICE, log=log)
        seconds = time.perf_counter() - t0
        got = taken()
        n_steps = len(tr["preempted"]) + len(tr["restarted"]) + len(tr["uninterrupted"])
        layers = smoke_of[tr["function"]].n_layers
        want = forward_launches({})["want"]
        want.update(flash_attention=layers * n_steps, flash_attention_bwd=layers * n_steps)
        rs = tr["restore_stats"]
        line(example="torch_train_fault_tolerant", seconds=seconds, function=tr["function"],
             steps=[len(tr["preempted"]), len(tr["restarted"]), len(tr["uninterrupted"])],
             restarted_tail=tr["restarted"][-train.TAIL:],
             uninterrupted_tail=tr["uninterrupted"][-train.TAIL:],
             tail_rel_diff=tr["tail_rel_diff"], rtol=TRAIN_RESTART_RTOL,
             restore={k: rs[k] for k in ("bytes", "io_s", "n_faults")},
             first_loss=tr["uninterrupted"][0], last_loss=tr["uninterrupted"][-1],
             launches=got, want_launches=want,
             formula=f"{layers} layers x {n_steps} steps, forward and backward")
        if (tr["tail_rel_diff"] > TRAIN_RESTART_RTOL or rs["n_faults"]
                or len(tr["restarted"]) != EXAMPLE_TRAIN_STEPS // 2):
            raise AssertionError(f"torch_train_fault_tolerant: tail {tr['tail_rel_diff']} "
                                 f"(rtol {TRAIN_RESTART_RTOL}), {rs['n_faults']} faults")
        if got != want:
            raise AssertionError(f"torch_train_fault_tolerant: launches {got}, want {want}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return total


# -- phase 7: decode paths ---------------------------------------------------

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
# deepseek-moe-16b in bfloat16 routes 7% of its decisions otherwise in the
# plain run than in the kernel run (near ties, ``RouteLog``; 8,365 of
# 114,048 on the H100), so it too is held through a float32 twin, of its
# first 8 layers, routed as its kernel run was: within 2e-4 of the plain
# run, ten times its H100 reading (1.63e-5), rounded up.
# qwen2-7b in bfloat16 differs from its plain run by more than PLAIN_ULPS
# at full depth, though each kernel call on its inputs is within half an
# ulp of plain: the differences add up layer by layer.  Its prefill's
# logits through the kernels against plain read 1.1, 2.8, 4.8 and 7.1
# ulps over its first 2, 7, 14 and 28 layers on the H100, and the 28-layer
# decode run 7.25 ulps against plain and 7.75 against the teacher-forced
# forward.  So its 28-layer bfloat16 run is held to the teacher-forced
# forward only; its prefill through the kernels is held to plain within
# PLAIN_ULPS over its first DEPTH_SWEEP layers (``depth_sweep``); and its
# float32 twin runs at full depth within the MoE twin's 2e-4 (the same
# attention and MLP blocks; set before its first reading, 1.09e-4 against
# the forward and 8.4e-5 against plain on the H100).
F32_ATOL = {"hybrid": 0.01, "rwkv": 1e-3,       # zamba2-1.2b, rwkv6-7b
            "moe": 2e-4, "dense": 2e-4}         # deepseek-moe-16b, qwen2-7b
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
                  "flash_attention_bwd": ("flash_bwd",),
                  "decode_attention": ("decode_split", "decode_combine"),
                  "ssd_scan": ("ssd_chunks", "ssd_step"),
                  "ssd_scan_bwd": ("ssd_bwd",),
                  "wkv6_scan": ("wkv6_chunks", "wkv6_steps"),
                  "wkv6_scan_bwd": ("wkv6_bwd",)}
F32_KERNEL_ATOL = {"flash_attention": FLASH_ATOL["float32"],
                   "decode_attention": DECODE_ATOL["float32"], "ssd_scan": SSD_ATOL,
                   "wkv6_scan": 1.2e-5}


def flash_per_pass(cfg) -> int:
    """B3 launches of one prefill or forward: each self-attention layer over
    the prompt (an encoder's layers too)."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    if cfg.family == "encdec":
        return (cfg.n_enc_layers or cfg.n_layers) + cfg.n_layers
    return cfg.n_layers if cfg.family in ("dense", "vlm", "moe") else 0


def decode_per_step(cfg) -> int:
    """B4 launches of one decode step: each self-attention layer over its
    cache, and a decoder layer's cross-attention over its frames."""
    return 2 * cfg.n_layers if cfg.family == "encdec" else flash_per_pass(cfg)


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


def sync() -> None:
    """Wait for the card (nothing to wait for where ``DEVICE`` is the CPU)."""
    import torch
    if torch.device(DEVICE).type == "cuda":
        torch.cuda.synchronize()


def make_prompt(cfg) -> dict:
    """The decode paths' prompt, from numpy seed ``SEED``, on ``DEVICE``:
    ``DECODE_BATCH`` x ``PROMPT`` tokens, after ``n_patches`` patch
    embeddings for a VLM, with ``PROMPT // frame_stride`` frame embeddings
    for an encoder-decoder (``launch.steps.make_batch``: the tokens are a
    direct ``integers`` draw from the seed, whatever the family)."""
    import torch
    from repro_torch.launch import steps
    seq = PROMPT + (cfg.n_patches if cfg.family == "vlm" else 0)
    batch = steps.make_batch(cfg, seq, DECODE_BATCH, "prefill", SEED)
    return {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()}


def trunk_len(prompt: dict) -> int:
    """The cache positions a prompt fills: its tokens, after its patches."""
    patches = prompt.get("patch_embeds")
    return prompt["tokens"].shape[1] + (0 if patches is None else patches.shape[1])


def generate(cfg, params, prompt: dict, n_steps: int, *, plain: bool = False,
             forced=None, float32: bool = False) -> dict:
    """Prefill ``prompt`` (``make_prompt``'s inputs) into a fresh cache,
    then ``n_steps`` decode steps: greedy, or fed ``forced`` (B, n_steps)
    tokens.  Returns each step's logits (prefill first), the tokens fed,
    seconds, and the cache."""
    import torch
    from repro_torch.launch import steps
    B, P = prompt["tokens"].shape[0], trunk_len(prompt)
    cache = steps.init_cache(cfg, B, P + n_steps, DEVICE)
    if float32:
        cache = float32_tree(cache)
    prefill = steps.build_prefill_step(cfg)
    decode = steps.build_decode_step(cfg)
    sync()
    t0 = time.perf_counter()
    logits, cache = prefill(params, prompt, cache, plain=plain)
    sync()
    prefill_s = time.perf_counter() - t0
    out, fed = [logits[:, -1].float()], []
    t0 = time.perf_counter()
    for i in range(n_steps):
        tok = (logits[:, -1].argmax(-1, keepdim=True) if forced is None
               else forced[:, i:i + 1])
        fed.append(tok)
        logits, cache = decode(params, cache, {"tokens": tok}, P + i, plain=plain)
        out.append(logits[:, -1].float())
    sync()
    decode_s = (time.perf_counter() - t0) / max(n_steps, 1)
    return {"logits": torch.stack(out, 1), "fed": torch.cat(fed, 1),
            "prefill_s": prefill_s, "decode_step_s": decode_s, "cache": cache}


class RouteLog:
    """An MoE run's routing, recorded by (MoE layer, position) and replayed
    in another run over the same positions.

    A kernel's error and its plain version's differ by ulps, so a token
    whose k-th and (k+1)-th experts are about as close swaps one for the
    other between two runs, and what later tokens attend to moves with it;
    over ~110 k decisions a prefill, some will.  So the kernel run records
    ``moe.route``'s expert ids and probabilities, and the plain run and the
    teacher-forced forward route by the recorded ids (gates from their own
    probabilities).  Each replaying call also takes its own top-k: a
    decision that differs must be a near tie, its margin (the largest gap,
    in its own probabilities, between an expert it would pick and the
    recorded one it drops) at most its bound (the two runs' probabilities
    of those experts moved by that much at most: a swap of two experts
    needs their order to flip, so their gap is at most the sum of their
    moves, which are what the kernels' per-call errors became through the
    layers below).  A call's position span: a prompt (S > 1) starts at 0,
    a step continues its layer's last span."""

    SHOWN = 64                          # margins printed per run, largest first

    def __init__(self, cfg, batch: int, max_len: int, device):
        import torch
        from repro_torch.models import moe
        self.n = moe.n_groups(cfg)
        self.idx = torch.zeros((self.n, batch, max_len, cfg.top_k), dtype=torch.long,
                               device=device)
        self.probs = torch.zeros((self.n, batch, max_len, cfg.n_experts),
                                 dtype=torch.float32, device=device)
        self.runs: dict[str, dict] = {}
        self._end = [0] * self.n

    @contextlib.contextmanager
    def active(self, mode: str, label: str | None = None):
        """Within the block ``moe.route`` records (``mode="record"``) or
        replays; the run's counts go under ``label`` (default: the mode)."""
        import itertools

        import torch
        from repro_torch.models import moe
        stats = self.runs.setdefault(label or mode, {"mode": mode, "decisions": 0,
                                                     "dropped": [], "rows": []})
        calls = itertools.count()
        saved = moe.route

        def route(p, x, cfg):
            layer = next(calls) % self.n
            lo = 0 if x.shape[1] > 1 else self._end[layer]
            hi = self._end[layer] = lo + x.shape[1]
            probs = moe.router_probs(p, x)
            _, own = moe.top_k(probs, cfg.top_k)
            if mode == "record":
                self.idx[layer, :, lo:hi] = own
                self.probs[layer, :, lo:hi] = probs
                idx = own
            else:
                idx = self.idx[layer, :, lo:hi]
                stats["rows"].append(self._swaps(probs, own, self.probs[layer, :, lo:hi], idx))
            n_tok = x.shape[0] * x.shape[1]
            ranks = moe.slot_ranks(idx.reshape(-1), cfg.n_experts)
            stats["dropped"].append(torch.sum(ranks >= moe.capacity(cfg, n_tok)))
            stats["decisions"] += n_tok
            return moe.gates_at(probs, idx), idx
        moe.route = route
        try:
            yield stats
        finally:
            moe.route = saved

    @staticmethod
    def _swaps(p, own, q, ref):
        """(margin, bound, differs) per token, on the device (no wait)."""
        import torch
        p64, q64 = p.double(), q.double()

        def member(ix):
            return torch.zeros_like(p, dtype=torch.bool).scatter_(-1, ix, True)
        mine, theirs = member(own), member(ref)
        a, b = mine & ~theirs, theirs & ~mine
        moved = (p64 - q64).abs()
        inf = torch.tensor(float("inf"), dtype=torch.float64, device=p.device)
        margin = (torch.where(a, p64, -inf).amax(-1) - torch.where(b, p64, inf).amin(-1))
        bound = (torch.where(a, moved, 0).amax(-1) + torch.where(b, moved, 0).amax(-1))
        return torch.stack([margin, bound, a.any(-1).double()], -1).reshape(-1, 3)

    def summary(self) -> dict:
        """Per run: decisions (token x MoE layer), assignments dropped past
        capacity, decisions that differ from the recorded ones with their
        margins and bounds (the largest ``SHOWN`` margins)."""
        import torch
        out = {}
        for label, st in self.runs.items():
            rows = (torch.cat(st["rows"]).cpu() if st["rows"]
                    else torch.zeros((0, 3), dtype=torch.float64))
            swaps = rows[rows[:, 2] > 0]
            order = torch.argsort(swaps[:, 0], descending=True)[:self.SHOWN]
            out[label] = {
                "mode": st["mode"], "decisions": st["decisions"],
                "dropped": int(sum(int(d) for d in st["dropped"])),
                "differing": len(swaps),
                "margins": swaps[order, 0].tolist(), "bounds": swaps[order, 1].tolist(),
                "worst_margin_over_bound": float(
                    (swaps[:, 0] / swaps[:, 1].clamp_min(1e-300)).max())
                if len(swaps) else 0.0}
        return out


@contextlib.contextmanager
def routing(log: RouteLog | None, mode: str, label: str):
    """``log.active(mode, label)``, or nothing without a log."""
    if log is None:
        yield None
    else:
        with log.active(mode, label) as stats:
            yield stats


def run_decode_path(label: str, cfg, params, n_steps: int, t_start: float, *,
                    float32: bool = False,
                    held: tuple = ("teacher", "plain")) -> dict:
    """One decode path: the kernel run (its launches counted), the teacher-
    forced forward, and the run through the plain versions on the same
    tokens; an MoE config's forward and plain run route as the kernel run
    did (``RouteLog``).  ``float32`` casts params and cache to float32;
    ``held`` names the runs the logits are held to (the teacher-forced
    forward, the plain run).  Raises on
    any failed check; returns the emitted line."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import steps
    prompt = make_prompt(cfg)
    P = trunk_len(prompt)
    if float32:
        params = float32_tree(params)
    log = RouteLog(cfg, DECODE_BATCH, P + n_steps, DEVICE) if cfg.family == "moe" else None
    reset_launches()
    with routing(log, "record", "kernel"):
        run = generate(cfg, params, prompt, n_steps, float32=float32)
    tokens = torch.cat([prompt["tokens"], run["fed"].to(prompt["tokens"].dtype)], 1)
    t0 = time.perf_counter()
    with routing(log, "replay", "forward"):
        full = steps.build_forward(cfg)(params, {**prompt, "tokens": tokens})
    sync()
    forward_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    # one more decode step of the last token and more prefills, traced
    # outside the count: they rewrite the same cache rows (Mamba states move
    # on, unused after)
    cache, decode = run.pop("cache"), steps.build_decode_step(cfg)
    last = {"tokens": run["fed"][:, -1:]}
    step_profile = profile_forward(
        lambda: decode(params, cache, last, P + n_steps - 1),
        kernels={k: DEVICE_KERNELS[k] for k in ("decode_attention", "ssd_scan",
                                                "wkv6_scan")})
    prefill_profile = profile_forward(
        lambda: steps.build_prefill_step(cfg)(params, prompt, cache),
        iters=2, kernels={k: DEVICE_KERNELS[k] for k in ("flash_attention", "ssd_scan",
                                                         "wkv6_scan")})
    del cache
    # one prefill and one decode step more, each kernel call held to its
    # plain version on the same inputs (outside the count)
    with kernels_held_to_plain() as per_call:
        generate(cfg, params, prompt, 1, forced=run["fed"], float32=float32)
    want_calls = {"flash_attention": flash_per_pass(cfg),
                  "decode_attention": decode_per_step(cfg),
                  "ssd_scan": 2 * mamba_layers(cfg), "wkv6_scan": 2 * rwkv_layers(cfg)}
    calls = {k: n for k, n in want_calls.items() if n}
    if {k: r["calls"] for k, r in per_call.items()} != calls:
        raise AssertionError(f"{label}: held kernel calls {per_call}, want {calls}")
    want = {"flash_attention": flash_per_pass(cfg) * 2,            # prefill + forward
            "decode_attention": decode_per_step(cfg) * n_steps,
            "ssd_scan": mamba_layers(cfg) * (1 + n_steps + 1),    # prefill, steps, forward
            "wkv6_scan": rwkv_layers(cfg) * (1 + n_steps + 1),
            "gather_pages": 0, "scatter_pages": 0, "flash_attention_bwd": 0,
            "ssd_scan_bwd": 0, "wkv6_scan_bwd": 0}
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, want {want}")
    logits = run["logits"]                                     # (B, 1 + steps, vocab)
    shape = (DECODE_BATCH, 1 + n_steps, cfg.vocab)
    check_logits(label, logits, shape)
    teacher = full[:, P - 1:P + n_steps].float()
    teacher_err = float((logits - teacher).abs().max())
    atol = TEACHER_ULPS * bf16_ulp(teacher)
    if cfg.kv_cache_dtype == "int8":
        atol += INT8_REL * float(teacher.abs().max())
    del full, teacher
    with routing(log, "replay", "plain"):
        plain = generate(cfg, params, prompt, n_steps, plain=True, forced=run["fed"],
                         float32=float32)
    del plain["cache"]
    plain_err = float((logits - plain["logits"]).abs().max())
    plain_atol = PLAIN_ULPS * bf16_ulp(plain["logits"])
    if float32:
        atol = plain_atol = F32_ATOL[cfg.family]
    if "teacher" not in held:
        atol = None
    if "plain" not in held:
        plain_atol = None
    routes = None if log is None else log.summary()
    # capacity differs between the prefill, the steps and the forward (4096,
    # 4 and 4224 tokens at full width), so the forward can drop what the
    # run kept: held to it only where neither dropped an assignment
    if routes and (routes["kernel"]["dropped"] or routes["forward"]["dropped"]):
        atol = None
    res = {"phase": "decode_path", "path": label, "t": time.perf_counter() - t_start,
           "function": cfg.name, "n_layers": cfg.n_layers,
           "kv_cache_dtype": cfg.kv_cache_dtype,
           "dtype": "float32" if float32 else cfg.dtype, "batch": DECODE_BATCH,
           "prompt": {k: list(v.shape) for k, v in prompt.items()},
           "decode_steps": n_steps,
           "prefill_s": run["prefill_s"], "decode_step_s": run["decode_step_s"],
           "forward_s": forward_s, "plain_prefill_s": plain["prefill_s"],
           "plain_decode_step_s": plain["decode_step_s"],
           "teacher_forced_max_abs": teacher_err, "teacher_atol": atol,
           "kernel_vs_plain_max_abs": plain_err, "plain_atol": plain_atol,
           "max_abs_logit": float(logits.abs().max()),
           "logits_finite": True, "launches": launches,
           "kernel_calls_vs_plain": per_call, "routing": routes,
           "decode_step_profile": step_profile, "prefill_profile": prefill_profile}
    if label in REDUCED:
        res["reduced"] = REDUCED[label]
    emit(res)
    if (atol is not None and teacher_err > atol) or (plain_atol is not None
                                                      and plain_err > plain_atol):
        raise AssertionError(f"{label}: teacher-forced err {teacher_err} (atol {atol}), "
                             f"kernel vs plain {plain_err} (atol {plain_atol})")
    off = {k: r for k, r in per_call.items() if r["worst_err_over_atol"] > 1}
    if off:
        raise AssertionError(f"{label}: kernel calls differ from their plain "
                             f"versions on the model's inputs: {off}")
    bad = {run: r for run, r in (routes or {}).items() if r["worst_margin_over_bound"] > 1}
    if bad:
        raise AssertionError(f"{label}: routing decisions differ past their bound: {bad}")
    return res


# The depth cuts, each listed on its path's line.  The VLM differs from
# the dense family only in its trunk (patch embeddings before the tokens),
# so 8 of pixtral-12b's 40 layers run its path at full width.
# deepseek-moe-16b's paths take its first 8 of 28 layers (its leading
# dense layer and seven MoE groups): its float32 twin for memory (18.5 GB
# beside the 32.7 GB of bfloat16 params on the card), its bfloat16 path
# for time, whose host ``init_params`` of 16.4 B parameters (94 s) paid
# for the qwen2-7b path and the examples.
VLM_LAYERS, MOE_LAYERS_DECODE = 8, 8
REDUCED = {
    "pixtral-12b": {"n_layers": [40, VLM_LAYERS],
                    "why": "the VLM differs from the dense family only in its "
                           "trunk; depth costs the smoke's time, not coverage"},
    "deepseek-moe-16b": {"n_layers": [28, MOE_LAYERS_DECODE],
                         "why": "the smoke's time: host init_params of 16.4 B "
                                "parameters took 94 s; width and the MoE "
                                "groups' routing are unchanged"},
    "deepseek-moe-16b/f32": {"n_layers": [28, MOE_LAYERS_DECODE],
                             "why": "its float32 params (18.5 GB) beside the "
                                    "bfloat16 ones (32.7 GB) on the card"},
}


# Depths at which a bfloat16 prefill through the kernels is held to one
# through the plain versions within PLAIN_ULPS (the first n layers of the
# full params)
DEPTH_SWEEP = {"qwen2-7b": (2, 7)}


def depth_sweep(cfg, params, depths, t_start: float) -> dict:
    """The prefill's last logits through the kernels against the plain
    versions' on the first n layers of ``params``, for each n of
    ``depths``, in bfloat16 ulps at the plain logits' largest magnitude,
    each within PLAIN_ULPS.  Outside the launch counts.  Raises past the
    bound; returns the emitted line."""
    from repro_torch.launch import steps
    prompt = make_prompt(cfg)
    B, P = prompt["tokens"].shape[0], trunk_len(prompt)
    ulps = {}
    for n in depths:
        cut, p = first_layers(cfg, params, n)
        got, want = (steps.build_prefill_step(cut)(
            p, prompt, steps.init_cache(cut, B, P, DEVICE), plain=plain)[0][:, -1].float()
            for plain in (False, True))
        ulps[n] = float((got - want).abs().max()) / bf16_ulp(want)
    res = {"phase": "decode_path", "path": f"{cfg.name}/depth_sweep",
           "t": time.perf_counter() - t_start, "function": cfg.name,
           "prefill_kernel_vs_plain_ulps": ulps, "plain_ulps": PLAIN_ULPS}
    emit(res)
    off = {n: u for n, u in ulps.items() if u > PLAIN_ULPS}
    if off:
        raise AssertionError(f"{cfg.name}: prefill through the kernels vs plain, "
                             f"ulps by depth {off} (bound {PLAIN_ULPS})")
    return res


def phase_decode_paths(t_start: float) -> dict:
    """olmo-1b with a bfloat16 and an int8 KV cache; qwen2-7b, zamba2-1.2b,
    rwkv6-7b and deepseek-moe-16b (its first ``MOE_LAYERS_DECODE``) each
    in bfloat16 and as a float32 twin, qwen2-7b's bfloat16 prefill also at
    ``DEPTH_SWEEP``'s depths; pixtral-12b (its first ``VLM_LAYERS``
    layers) and seamless-m4t-medium in bfloat16; full width, from numpy
    seed 0.  Returns launches summed over the paths."""
    import dataclasses

    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.launch import steps
    total: dict[str, int] = {}
    # (function, depth cut, ((label, KV cache dtype, steps, float32 twin,
    #  runs the logits are held to), ...))
    both = ("teacher", "plain")
    for function, depth, paths in (
            ("olmo-1b", None,
             (("olmo-1b", "bfloat16", DECODE_STEPS, False, both),
              ("olmo-1b/int8", "int8", INT8_STEPS, False, both))),
            ("zamba2-1.2b", None,
             (("zamba2-1.2b", "bfloat16", DECODE_STEPS, False, ()),
              ("zamba2-1.2b/f32", "bfloat16", F32_STEPS, True, both))),
            ("rwkv6-7b", None,
             (("rwkv6-7b", "bfloat16", DECODE_STEPS, False, ()),
              ("rwkv6-7b/f32", "bfloat16", F32_STEPS, True, both))),
            ("qwen2-7b", None,
             (("qwen2-7b", "bfloat16", DECODE_STEPS, False, ("teacher",)),
              ("qwen2-7b/f32", "bfloat16", F32_STEPS, True, both))),
            ("deepseek-moe-16b", MOE_LAYERS_DECODE,
             (("deepseek-moe-16b", "bfloat16", DECODE_STEPS, False, ()),
              ("deepseek-moe-16b/f32", "bfloat16", F32_STEPS, True, both))),
            ("pixtral-12b", VLM_LAYERS,
             (("pixtral-12b", "bfloat16", DECODE_STEPS, False, both),)),
            ("seamless-m4t-medium", None,
             (("seamless-m4t-medium", "bfloat16", DECODE_STEPS, False, both),))):
        base = ARCHS[function]
        if depth is not None:
            base = dataclasses.replace(base, n_layers=depth)
        t0 = time.perf_counter()
        with host_peak({"phase": "decode_path", "function": function,
                        "step": "init_params", "n_layers": base.n_layers}) as line:
            params = steps.init_params(base, SEED, DEVICE)
            sync()
        emit({**line, "seconds": time.perf_counter() - t0,
              "params": sum(t.numel() for t in _leaves(params))})
        for label, kvd, n_steps, float32, held in paths:
            res = run_decode_path(label, dataclasses.replace(base, kv_cache_dtype=kvd),
                                  params, n_steps, t_start, float32=float32, held=held)
            for k, n in res["launches"].items():
                total[k] = total.get(k, 0) + n
            torch.cuda.empty_cache()
        if function in DEPTH_SWEEP:
            depth_sweep(base, params, DEPTH_SWEEP[function], t_start)
        del params
        torch.cuda.empty_cache()
    return total


# -- phase 8: training ----------------------------------------------------------

TRAIN_FUNCTION = "olmo-1b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_F32_LAYERS = 4, 1024, 6, 4
TRAIN_CKPT_EVERY, TRAIN_PREEMPT_AT = 3, 4
TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
# One step through the kernels against one through their plain versions,
# same params and batch.  bfloat16: the loss within a quarter of one
# bfloat16 ulp of its magnitude (2**-10 relative): it is a float32 mean
# over 4,092 targets of terms whose logits differ by rounding flips of at
# most PLAIN_ULPS ulps at a small share of entries, and flips of both
# signs average out (H100 reading 1.65e-5 relative).  Each gradient leaf
# within TRAIN_GRAD_ULPS bfloat16 ulps of its largest magnitude: the
# forward's logits stay within PLAIN_ULPS (4) after 16 layers, and a
# gradient crosses the 16 layers forward and then backward, each rounding
# its own way, so four times that (H100 reading: 3 to 6 ulps).  float32
# twin of the first TRAIN_F32_LAYERS layers: both sides compute in float32
# and differ only by the order of their sums; the loss within 1e-6 of its
# magnitude and each leaf within 3e-5 of its largest magnitude, ten times
# the H100 reading (3.2e-6) and near the CPU's JAX-against-port bound
# (2e-5, tests/test_torch_training.py).
TRAIN_LOSS_RTOL = {"bfloat16": 2.0 ** -10, "float32": 1e-6}
TRAIN_GRAD_ULPS = 16
TRAIN_F32_GRAD_REL = 3e-5
# zamba2-1.2b's float32 twin (4 layers) reads its loss within 8.8e-8 of
# the plain step's but gradients within 2.6e-4 (embed/table; lm_head/w,
# whose gradient sees only the forward, 5.2e-5) on the H100: with random
# weights the family amplifies one rounding difference of its scans
# (F32_ATOL's reason; a 1e-6 nudge of every SSD output moves float32
# logits by up to 1e-3, tests/test_torch_hybrid.py), and the forward's
# split-TF32 B6 differs from the plain scan by rounding.  Its gradients
# are held to ten times that reading; the loss to TRAIN_LOSS_RTOL.
TRAIN_HYBRID_F32_GRAD_REL = 3e-3
# zamba2-1.2b's bfloat16 step against the plain one (remat on both sides):
# the loss read 6.44e-4 relative and the worst leaf 312.5 bf16 ulps
# (groups/mamba/block/wdt) on the H100 (run 1, PR 21).  Run again with
# one half of B6 plain at a time: B6's forward kernel with the plain
# backward read the same (6.44e-4, 312.5 ulps; worst relative leaf
# groups/mamba/block/wo), the plain forward with B6's backward kernel
# 1.54e-4 and 161 ulps (its loss moved by B3 alone).  So the forward
# kernel's rounding, which random weights amplify through 38 layers (as
# F32_ATOL's reason), moves these gradients; the backward kernel does not
# add to it.  A leaf 312 ulps off is already off by more than its largest
# magnitude, so a bound on the bf16 step can only catch a gross fault: the
# loss within TRAIN_LOSS_RTOL and each leaf within about three times the
# largest of the three readings.  The float32 twin
# (TRAIN_HYBRID_F32_GRAD_REL) is the check of the backward's arithmetic.
TRAIN_HYBRID_BF16_GRAD_ULPS = 1024
# The restarted run's losses of steps 4-6 against the uninterrupted run's:
# the same bytes go into the same deterministic arithmetic (no kernel of
# the step uses atomics), so they should be equal; 1e-6 relative leaves
# room for a library reduction whose order varies from run to run.
TRAIN_RESTART_RTOL = 1e-6


def tree_bytes_on_disk(path: str) -> int:
    """Bytes allocated to the files under ``path`` (a sparse file counts
    what it has written)."""
    total = 0
    for d, _, names in os.walk(path):
        for n in names:
            try:
                total += os.stat(os.path.join(d, n)).st_blocks * 512
            except OSError:
                pass                      # renamed or removed meanwhile
    return total


@contextlib.contextmanager
def disk_peak(path: str, out: dict, every_s: float = 0.25):
    """Samples ``tree_bytes_on_disk(path)`` within the block; sets
    ``out["disk_peak_gb"]``."""
    import threading
    seen, stop = [0], threading.Event()

    def sample():
        while True:
            seen.append(tree_bytes_on_disk(path))
            if stop.wait(every_s):
                return
    t = threading.Thread(target=sample, daemon=True)
    t.start()
    try:
        yield out
    finally:
        stop.set()
        t.join()
        seen.append(tree_bytes_on_disk(path))
        out["disk_peak_gb"] = max(seen) / 1e9


def grad_errors(loss: float, grads, ploss: float, pgrads) -> dict:
    """A step's loss and gradients against the plain step's: the losses,
    their difference, and each gradient leaf's largest difference over the
    plain gradient's largest magnitude (and in bf16 ulps of it)."""
    import torch
    from repro_torch.training.optimizer import tree_leaves
    if not (math.isfinite(loss) and math.isfinite(ploss)):
        raise AssertionError(f"train step: loss {loss}, plain loss {ploss}")
    rel, ulps = {}, {}
    for (path, g), (_, w) in zip(tree_leaves(grads), tree_leaves(pgrads)):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"train step: gradient {path} not finite")
        if not bool(torch.isfinite(w).all()):
            raise AssertionError(f"train step: plain gradient {path} not finite")
        w = w.float()
        m = float(w.abs().max())
        err = float((g.float() - w).abs().max())
        rel[path] = err / m if m else err
        ulps[path] = err / bf16_ulp(w) if m else err
    worst = max(rel, key=rel.get)
    worst_u = max(ulps, key=ulps.get)
    return {"loss": loss, "plain_loss": ploss, "loss_rel_err": abs(loss - ploss) / abs(ploss),
            "grad_rel_err": rel, "grad_err_bf16_ulps": ulps, "worst_leaf": worst,
            "worst_rel_err": rel[worst], "worst_ulps": ulps[worst_u], "worst_ulps_leaf": worst_u}


def grads_vs_plain(cfg, params, batch, *, remat: bool = False,
                   variants: dict | None = None) -> dict:
    """One loss and gradient through the kernels and one through their
    plain versions, on the same params and batch (both with ``remat`` or
    both without), compared by ``grad_errors``; then the kernel step again
    under each of ``variants`` ({name: a context manager factory}), each
    held to the same plain step (under ``"variants"``)."""
    from repro_torch.launch import steps

    def step(plain: bool):
        sync()
        t0 = time.perf_counter()
        loss, grads = steps.loss_and_grads(cfg, params, batch, remat=remat, plain=plain)
        sync()
        return float(loss), grads, time.perf_counter() - t0
    ploss, pgrads, ps = step(True)
    loss, grads, ks = step(False)
    res = {**grad_errors(loss, grads, ploss, pgrads), "kernel_s": ks, "plain_s": ps}
    del grads
    for name, make in (variants or {}).items():
        with make():
            vloss, vgrads, vs = step(False)
        res.setdefault("variants", {})[name] = {
            k: v for k, v in grad_errors(vloss, vgrads, ploss, pgrads).items()
            if k not in ("grad_rel_err", "grad_err_bf16_ulps")} | {"kernel_s": vs}
        del vgrads
    return res


@contextlib.contextmanager
def ssd_halves(kernel_forward: bool):
    """``models.mamba2``'s scan with one half of B6 on the card and the
    other plain: B6's forward kernel with autograd of the plain scan as
    its backward (``kernel_forward``), or the plain scan's forward with
    the backward kernel.  Shows which kernel moves a bfloat16 step's
    gradients."""
    import torch
    from repro_torch.kernels.mamba2_scan import ops, ssd_scan_ref
    from repro_torch.models import mamba2

    class Half(torch.autograd.Function):
        @staticmethod
        def forward(ctx, chunk, *args):
            ctx.chunk = chunk
            ctx.save_for_backward(*args)
            return ops._forward(*args) if kernel_forward else ssd_scan_ref(*args, chunk=chunk)

        @staticmethod
        def backward(ctx, dy, dhT):
            args = ctx.saved_tensors
            need = ctx.needs_input_grad[1:]
            if kernel_forward:
                leaves = [t.detach().requires_grad_(n) for t, n in zip(args, need)]
                with torch.enable_grad():
                    outs = ssd_scan_ref(*leaves, chunk=ctx.chunk)
                wanted = [t for t in leaves if t.requires_grad]
                got = iter(torch.autograd.grad(outs, wanted, (dy, dhT)))
                return (None, *(next(got) if n else None for n in need))
            grads = ops.ssd_scan_bwd(*args, dy.float(), dhT)
            return (None, *(g.to(t.dtype) if n else None for g, t, n in zip(grads, args, need)))

    def scan(x, dt, A, B, C, h0, *, chunk: int = 128):
        return Half.apply(chunk, x, dt, A, B, C, h0)
    old = mamba2.ssd_scan
    mamba2.ssd_scan = scan
    try:
        yield
    finally:
        mamba2.ssd_scan = old


def first_layers(cfg, params: dict, n: int):
    """A dense, hybrid or RWKV config cut to its first ``n`` layers, and
    views of ``params``' stacks for them (a hybrid's groups of
    ``attn_every`` Mamba layers)."""
    import dataclasses

    from repro_torch.training import optimizer as opt_lib
    key, m = (("groups", n // cfg.attn_every) if cfg.family == "hybrid"
              else ("layers", n))
    return (dataclasses.replace(cfg, n_layers=n),
            {**params, key: opt_lib.tree_map(lambda t: t[:m], params[key])})


def kernel_vs_plain(cfg, params, batch, n_f32: int, t_start: float, *,
                    gate_bf16: bool, remat_bf16: bool = False,
                    f32_grad_rel: float = TRAIN_F32_GRAD_REL,
                    bf16_grad_ulps: float = TRAIN_GRAD_ULPS,
                    extra: dict | None = None, variants: dict | None = None) -> dict:
    """A step's loss and gradients through the kernels against the plain
    versions': in bfloat16 (gated by ``TRAIN_LOSS_RTOL`` and
    ``bf16_grad_ulps`` where ``gate_bf16``, else only finite) and in a
    float32 twin of the first ``n_f32`` layers (always gated: the loss by
    ``TRAIN_LOSS_RTOL``, each gradient leaf by ``f32_grad_rel``).  Emits the
    ``kernel_vs_plain`` line (with ``extra``'s keys), with the bfloat16
    step's peak device memory; ``variants`` go to the bfloat16 step
    (``grads_vs_plain``)."""
    import dataclasses

    import torch
    torch.cuda.reset_peak_memory_stats()
    bf16 = grads_vs_plain(cfg, params, batch, remat=remat_bf16, variants=variants)
    peak = torch.cuda.max_memory_allocated() / 1e9
    cut, p32 = first_layers(cfg, params, n_f32)
    cfg32 = dataclasses.replace(cut, dtype="float32")
    f32 = grads_vs_plain(cfg32, float32_tree(p32), batch)
    del p32
    torch.cuda.empty_cache()
    bounds = {"f32_loss_rel": TRAIN_LOSS_RTOL["float32"], "f32_grad_rel": f32_grad_rel}
    if gate_bf16:
        bounds.update(bf16_loss_rel=TRAIN_LOSS_RTOL["bfloat16"],
                      bf16_grad_ulps=bf16_grad_ulps)
    emit({"phase": "train_path", "step": "kernel_vs_plain",
          "t": time.perf_counter() - t_start, "function": cfg.name,
          "n_layers": cfg.n_layers, **(extra or {}), "batch": [TRAIN_BATCH, TRAIN_SEQ],
          "bounds": bounds, "bf16_remat": remat_bf16, "bf16_peak_gb": peak,
          "bfloat16": bf16, "float32_first_layers": {"n_layers": n_f32, **f32}})
    bad = []
    if gate_bf16 and bf16["loss_rel_err"] > bounds["bf16_loss_rel"]:
        bad.append(f"bf16 loss {bf16['loss_rel_err']}")
    if gate_bf16 and bf16["worst_ulps"] > bounds["bf16_grad_ulps"]:
        bad.append(f"bf16 grads {bf16['grad_err_bf16_ulps']}")
    if f32["loss_rel_err"] > bounds["f32_loss_rel"]:
        bad.append(f"f32 loss {f32['loss_rel_err']}")
    if f32["worst_rel_err"] > bounds["f32_grad_rel"]:
        bad.append(f"f32 grad {f32['worst_leaf']} {f32['worst_rel_err']}")
    if bad:
        raise AssertionError(f"{cfg.name} train step through the kernels vs plain: {bad}")
    return {"bfloat16": bf16, "float32": f32}


def counted_step(cfg, params, state, batch, opt, want: dict):
    """One train step (``remat=False``) with the launches counted from 0:
    exactly ``want`` ({kernel: launches}, every other kernel 0).  Emits the
    ``one_step`` line; returns the step function and its result."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import steps
    train_step = steps.build_train_step(cfg, opt, remat=False)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    sync()
    t0 = time.perf_counter()
    new_p, new_s, metrics = train_step(params, state, batch)
    sync()
    step_s = time.perf_counter() - t0
    one_step = dict(LAUNCHES)
    expected = {k: 0 for k in one_step}
    expected.update(want)
    emit({"phase": "train_path", "step": "one_step", "function": cfg.name,
          "seconds": step_s, "loss": float(metrics["loss"]),
          "grad_norm": float(metrics["grad_norm"]), "lr": float(metrics["lr"]),
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": one_step})
    if not math.isfinite(float(metrics["loss"])):
        raise AssertionError(f"{cfg.name} train step: loss {float(metrics['loss'])}")
    if one_step != expected:
        raise AssertionError(f"{cfg.name} train step launches {one_step}, want {expected}")
    return train_step, new_p, new_s


# The distributed path inside the train path: the elastic restores' meshes
# (data-parallel hosts; the last is the production 16 x 16 mesh) and the
# one whose restore takes the train step; the dry-run cell it traces.
DIST_MESHES = ({"data": 2}, {"data": 4}, {"data": 8}, None)
DIST_STEP_MESH = 2
DIST_DRYRUN = ("olmo-1b", "train_4k", "single")
DIST_PARAMS = 1_176_764_416          # olmo-1b's parameters (its spec tree)


def bitwise_equal(a, b) -> bool:
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    a, b = a.reshape(-1).contiguous(), b.reshape(-1).contiguous()
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@contextlib.contextmanager
def kept_gradients():
    """Within the block, ``launch.steps.loss_and_grads`` (which the train
    step calls) keeps its last gradients in the dict it yields."""
    from repro_torch.launch import steps
    kept: dict = {}
    real = steps.loss_and_grads

    def keep(*args, **kw):
        loss, grads = real(*args, **kw)
        kept["grads"] = grads
        return loss, grads
    steps.loss_and_grads = keep
    try:
        yield kept
    finally:
        steps.loss_and_grads = real


def distributed_path(cfg, work: str, ckpt_dir: str, saved: dict, opt_state,
                     first_loss: float, corpus: str, opt, loop, t_start: float) -> None:
    """The distributed and launch tooling on full-width olmo-1b's step-3
    checkpoint: (1) ``restore_for_mesh`` onto each of ``DIST_MESHES``,
    bitwise the saved parameters; (2) one ``Trainer`` step from the
    ``{data: 8}`` restore with the REAP-restored optimizer state and the
    step-4 batch, its loss bitwise the restarted run's first and exactly
    one B3 forward and backward per layer; (3) ``ef_psum`` over that
    step's gradients on a one-rank NCCL group, bitwise the local
    compression; (4) the ``DIST_DRYRUN`` dry-run cell.  Emits the
    ``distributed_path`` line, then raises on any failure."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from repro_torch.distributed import compress
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import Mesh, make_production_mesh
    from repro_torch.training import Trainer
    from repro_torch.training.checkpoint import restore_for_mesh
    from repro_torch.training.optimizer import tree_leaves, tree_map
    t_phase = time.perf_counter()
    base = os.path.join(ckpt_dir, f"ckpt_{TRAIN_CKPT_EVERY:08d}")
    if not os.path.exists(base + ".mem"):
        raise AssertionError(f"the step-{TRAIN_CKPT_EVERY} checkpoint is gone: "
                             f"{sorted(os.listdir(ckpt_dir))}")
    specs = steps.param_specs(cfg)
    restores, failures, step_params = [], [], None
    for i, shape in enumerate(DIST_MESHES):
        mesh = Mesh(dict(shape)) if shape else make_production_mesh()
        stats: dict = {}
        t0 = time.perf_counter()
        got = restore_for_mesh(base, specs, mesh, make_rules(mesh), device=DEVICE,
                               stats=stats)
        sync()
        sec = time.perf_counter() - t0
        unequal = [p for p, t in tree_leaves(got)
                   if not bitwise_equal(t, saved[f"params/{p}"])]
        restores.append({"mesh": dict(mesh.shape), "seconds": sec,
                         "bytes_read": stats["bytes"], "shard_reads": stats["reads"],
                         "n_unequal": len(unequal), "unequal": unequal[:5]})
        if unequal:
            failures.append(f"restore onto {dict(mesh.shape)}: unequal {unequal[:5]}")
        if i == DIST_STEP_MESH:
            step_params = got
        del got
    restored_params = sum(t.numel() for _, t in tree_leaves(step_params))

    # (2) one step from the {data: 8} restore
    class FromMesh(Trainer):
        def _resume_or_init(self):
            return step_params, opt_state, TRAIN_CKPT_EVERY
    one = dataclasses.replace(loop, total_steps=TRAIN_CKPT_EVERY + 1,
                              checkpoint_every=10 ** 9)
    trainer = FromMesh(cfg, opt, one, corpus, os.path.join(work, "mesh_step"),
                       device=DEVICE)
    before = dict(LAUNCHES)
    t0 = time.perf_counter()
    with kept_gradients() as kept:
        out = trainer.run()
    sync()
    step_s = time.perf_counter() - t0
    step_launches = {k: LAUNCHES[k] - before.get(k, 0) for k in LAUNCHES}
    want = {k: 0 for k in step_launches}
    want.update(flash_attention=cfg.n_layers, flash_attention_bwd=cfg.n_layers)
    loss = out["losses"][0] if out["losses"] else float("nan")
    if step_launches != want:
        failures.append(f"mesh step launches {step_launches}, want {want}")
    if out["losses"] != [first_loss]:
        failures.append(f"mesh step losses {out['losses']}, want [{first_loss}]")
    del trainer, step_params
    grads = kept.pop("grads")

    # (3) ef_psum on a one-rank NCCL group against the local compression
    errors = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                            device=g.device), grads)
    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(work, "nccl_store"), 1),
                            rank=0, world_size=1)
    try:
        backend = dist.get_backend()
        mean, new_err = compress.ef_psum(grads, errors)
        sync()
    finally:
        dist.destroy_process_group()
    psum_s = time.perf_counter() - t0
    qs, scales, local_err = compress.ef_compress_tree(grads, errors)
    local = dict(tree_leaves(compress.decompress_tree(qs, scales)))
    local_err = dict(tree_leaves(local_err))
    new_err = dict(tree_leaves(new_err))
    psum_unequal = [p for p, t in tree_leaves(mean)
                    if not (bitwise_equal(t, local[p]) and bitwise_equal(new_err[p], local_err[p]))]
    n_grad = sum(t.numel() for _, t in tree_leaves(grads))
    n_leaves = len(new_err)
    if psum_unequal:
        failures.append(f"ef_psum differs from the local compression: {psum_unequal[:5]}")
    del grads, errors, mean, new_err, qs, scales, local, local_err
    torch.cuda.empty_cache()

    # (4) the dry-run cell, traced on fake CPU tensors
    r = dryrun.run_cell(*DIST_DRYRUN, os.path.join(work, "dryrun"))
    if r["status"] != "ok":
        raise AssertionError(f"dry run {DIST_DRYRUN}: {r.get('traceback')}")
    if r["params_total"] != DIST_PARAMS:
        failures.append(f"dry run params_total {r['params_total']}, want {DIST_PARAMS}")
    emit({"phase": "train_path", "step": "distributed_path",
          "t": time.perf_counter() - t_start, "seconds": time.perf_counter() - t_phase,
          "checkpoint": os.path.basename(base), "restored_params": restored_params,
          "restores": restores,
          "mesh_step": {"mesh": dict(DIST_MESHES[DIST_STEP_MESH]), "seconds": step_s,
                        "loss": loss, "restarted_first_loss": first_loss,
                        "loss_bitwise": out["losses"] == [first_loss],
                        "launches": step_launches},
          "ef_psum": {"backend": backend, "world_size": 1, "leaves": n_leaves,
                      "grad_elements": n_grad, "seconds": psum_s,
                      "n_unequal": len(psum_unequal), "unequal": psum_unequal[:5]},
          "dryrun": {"cell": list(DIST_DRYRUN), "trace_s": r["trace_s"],
                     "params_total": r["params_total"],
                     "peak_bytes_per_device": r["peak_bytes_per_device"],
                     "fits_hbm": r["fits_hbm"],
                     "dot_flops_traced": r["traced"]["dot_flops"],
                     "microbatches": r["meta"]["microbatches"],
                     "flops_per_device": r["roofline"]["flops_per_device"],
                     "bottleneck": r["roofline"]["bottleneck"],
                     "step_s": r["roofline"]["step_s"]}})
    if failures:
        raise AssertionError("distributed path: " + "; ".join(failures))


def phase_train_path(t_start: float) -> dict:
    """Full-width, full-depth olmo-1b training through ``launch.steps`` and
    ``training.Trainer``: (1) one step's loss and gradients through the
    kernels against the plain versions, in bfloat16 and in a float32 twin
    of the first ``TRAIN_F32_LAYERS`` layers; (2) exactly one B3 forward
    and one backward per layer and step, no other kernel; (3) a run
    preempted after step ``TRAIN_PREEMPT_AT`` (checkpoint every
    ``TRAIN_CKPT_EVERY`` steps), restarted by REAP restore of the step-3
    checkpoint (0 faults, bitwise the saved tensors) to step
    ``TRAIN_STEPS``, against an uninterrupted run that saves nothing;
    (4) ``distributed_path`` on the step-3 checkpoint; (5) the times, the
    checkpoint's bytes and the directory's peak disk.
    Returns the launches of the counted window (reset just before the
    first step, read after the last run)."""
    import dataclasses
    import shutil
    import tempfile

    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.data import TokenDataset, synthesize_corpus
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch import steps
    from repro_torch.training import (OptConfig, SimulatedPreemption, Trainer,
                                      TrainLoopConfig)
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.optimizer import tree_leaves
    cfg = ARCHS[TRAIN_FUNCTION]
    work = tempfile.mkdtemp(prefix="train_", dir=os.path.join(ROOT, "build"))
    try:
        corpus = synthesize_corpus(
            os.path.join(work, f"corpus_{cfg.vocab}.bin"),
            max(TRAIN_STEPS * TRAIN_BATCH * TRAIN_SEQ * 2, 200_000), cfg.vocab)
        tokens = TokenDataset(corpus, TRAIN_SEQ).batch(0, TRAIN_BATCH)
        batch = {"tokens": torch.from_numpy(tokens).to(DEVICE)}
        t0 = time.perf_counter()
        params = steps.init_params(cfg, SEED, DEVICE)
        sync()
        init_s = time.perf_counter() - t0
        n_params = sum(t.numel() for _, t in tree_leaves(params))
        # (1) kernels against plain versions, bfloat16 and a float32 twin
        kernel_vs_plain(cfg, params, batch, TRAIN_F32_LAYERS, t_start, gate_bf16=True,
                        extra={"params": n_params, "init_s": init_s})

        # (2) one counted step: B3 forward and backward once per layer
        opt = OptConfig(**TRAIN_OPT)
        state = opt_lib.init_state(params, opt)
        train_step, new_p, new_s = counted_step(
            cfg, params, state, batch, opt,
            {"flash_attention": cfg.n_layers, "flash_attention_bwd": cfg.n_layers})
        del new_p, new_s, state
        torch.cuda.empty_cache()

        # (3) preempt, restart by REAP restore, and an uninterrupted run
        loop = TrainLoopConfig(total_steps=TRAIN_STEPS, checkpoint_every=TRAIN_CKPT_EVERY,
                               batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, remat=False,
                               restore_mode="reap")
        ckpt_dir = os.path.join(work, "ckpt")
        saved: dict = {}
        disk: dict = {}
        with disk_peak(work, disk):
            first = Trainer(cfg, opt, loop, corpus, ckpt_dir,
                            preempt_at=TRAIN_PREEMPT_AT, device=DEVICE)
            save = first.ckpt.save

            def keep_and_save(p, o, step):
                saved[step] = {path: t.detach().clone() for path, t in
                               tree_leaves({"params": p, "opt": o})}
                save(p, o, step)
            first.ckpt.save = keep_and_save
            t0 = time.perf_counter()
            try:
                first.run()
                raise AssertionError("the first run was not preempted")
            except SimulatedPreemption:
                pass
            first_s = time.perf_counter() - t0
            stage_s, write_s = first.ckpt.last_stage_s, first.ckpt.last_write_s
            ckpt_bytes = os.path.getsize(first.ckpt.latest() + ".mem")

            class Restarted(Trainer):
                def _resume_or_init(self):
                    t1 = time.perf_counter()
                    out = super()._resume_or_init()
                    sync()
                    self.restored, self.resume_s = out, time.perf_counter() - t1
                    return out
            second = Restarted(cfg, opt, loop, corpus, ckpt_dir, device=DEVICE)
            t0 = time.perf_counter()
            restarted = second.run()
            second_s = time.perf_counter() - t0
        rp, ro, rstep = second.restored
        got = dict(tree_leaves({"params": rp, "opt": ro}))
        want_saved = saved.pop(TRAIN_CKPT_EVERY)
        unequal = [p for p, t in want_saved.items()
                   if got[p].dtype != t.dtype or not torch.equal(
                       got[p].view(torch.uint8) if got[p].dim() else got[p],
                       t.view(torch.uint8) if t.dim() else t)]
        # (4) the distributed and launch tooling on the step-3 checkpoint
        distributed_path(cfg, work, ckpt_dir, want_saved, ro, restarted["losses"][0],
                         corpus, opt, loop, t_start)
        del second.restored, rp, ro, got, want_saved, saved
        torch.cuda.empty_cache()
        nockpt = dataclasses.replace(loop, checkpoint_every=10 ** 9)
        t0 = time.perf_counter()
        whole = Trainer(cfg, opt, nockpt, corpus, os.path.join(work, "none"),
                        device=DEVICE).run()
        whole_s = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        rs = restarted["restore_stats"]
        after = whole["losses"][TRAIN_CKPT_EVERY:]
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(restarted["losses"], after))
        res = {"phase": "train_path", "step": "preempt_restart",
               "t": time.perf_counter() - t_start, "restored_step": rstep,
               "first_run_s": first_s, "restarted_run_s": second_s,
               "uninterrupted_s": whole_s,
               "s_per_step": whole["seconds"] / TRAIN_STEPS,
               "checkpoint_bytes": ckpt_bytes, "host_stage_s": stage_s,
               "write_s": write_s, "restore": rs, "resume_s": second.resume_s,
               "restore_unequal_tensors": unequal[:5], "n_unequal": len(unequal),
               "restarted_losses": restarted["losses"],
               "uninterrupted_losses": whole["losses"],
               "restart_loss_rel_err": loss_err,
               "restart_losses_bitwise": restarted["losses"] == after,
               "restart_loss_rtol": TRAIN_RESTART_RTOL,
               "disk_peak_gb": disk["disk_peak_gb"], "launches": launches}
        emit(res)
        if rstep != TRAIN_CKPT_EVERY or rs["n_faults"] != 0 or unequal:
            raise AssertionError(f"REAP restore: step {rstep}, faults {rs['n_faults']}, "
                                 f"unequal tensors {unequal[:5]}")
        if len(restarted["losses"]) != TRAIN_STEPS - TRAIN_CKPT_EVERY or \
                loss_err > TRAIN_RESTART_RTOL:
            raise AssertionError(f"restarted losses {restarted['losses']} vs "
                                 f"uninterrupted {after}")
        # the counted step, the preempted and restarted runs, the step from
        # the elastic restore, and the uninterrupted run
        n_steps = 1 + TRAIN_PREEMPT_AT + (TRAIN_STEPS - TRAIN_CKPT_EVERY) + 1 + TRAIN_STEPS
        want = {k: 0 for k in launches}
        want.update(flash_attention=cfg.n_layers * n_steps,
                    flash_attention_bwd=cfg.n_layers * n_steps)
        if launches != want:
            raise AssertionError(f"train path launches {launches}, want {want}")

        # (5) one step traced (outside the count)
        state = opt_lib.init_state(params, opt)
        profile = profile_forward(
            lambda: train_step(params, state, batch), iters=2,
            kernels={k: DEVICE_KERNELS[k] for k in ("flash_attention",
                                                    "flash_attention_bwd")})
        emit({"phase": "train_path", "step": "train_step_profile", **profile})
        del params, state
        torch.cuda.empty_cache()
        return launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


# The scan families' train paths (zamba2-1.2b at full depth; rwkv6-7b cut
# to RWKV_TRAIN_LAYERS of its 32 layers), each with its float32 twin's
# first layers: (function, depth cut, twin layers, the twin's gradient
# bound, the bf16 step's gradient bound in ulps or None for ungated).
# AdamW at rwkv6-7b's full depth holds bf16 params and gradients and f32
# moments, 12 bytes a parameter: 7.53 B x 12 B = 90 GB, over the card's
# 80 GB before any activation; 8 layers hold 2.28 B parameters (27 GB).
# Their bfloat16 steps against the plain steps run with remat=True on both
# sides: the plain chunked scans' autograd graphs (about 8.6 GB a layer of
# wkv6_ref's (B, Lc, Lc, H, D) decays; zamba2's SSD and mha_ref ones
# over 38 layers) would not fit beside the model without it.
RWKV_TRAIN_LAYERS, SCAN_TRAIN_TIMED = 8, 3
SCAN_TRAIN = (("zamba2-1.2b", None, 4, TRAIN_HYBRID_F32_GRAD_REL, TRAIN_HYBRID_BF16_GRAD_ULPS),
              ("rwkv6-7b", RWKV_TRAIN_LAYERS, 2, TRAIN_F32_GRAD_REL, None))
REDUCED["rwkv6-7b/train"] = {
    "n_layers": [32, RWKV_TRAIN_LAYERS],
    "why": "AdamW state at 32 layers (90 GB at 12 bytes a parameter) is over "
           "the card's 80 GB"}


def scan_train_launches(cfg) -> dict:
    """B3, B5 and B6 launches of one remat=False train step: a forward and
    a backward per Mamba2 layer and per application of zamba2's shared
    attention block, per RWKV6 layer."""
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.attn_every
        return {"ssd_scan": cfg.n_layers, "ssd_scan_bwd": cfg.n_layers,
                "flash_attention": n_attn, "flash_attention_bwd": n_attn}
    return {"wkv6_scan": cfg.n_layers, "wkv6_scan_bwd": cfg.n_layers}


def phase_scan_train_paths(t_start: float) -> dict:
    """zamba2-1.2b and rwkv6-7b training at full width through
    ``launch.steps`` (bf16, AdamW, 4 x 1024 tokens of seed ``SEED``):
    (a) a float32 twin's step through the kernels against the plain one,
    gated as olmo-1b's (zamba2's gradients by ``TRAIN_HYBRID_F32_GRAD_REL``);
    (b) the bfloat16 step against the plain one, finite, its errors
    printed (random weights amplify one rounding flip in these families,
    ``F32_ATOL``), zamba2's gated by ``TRAIN_HYBRID_BF16_GRAD_ULPS`` and
    also taken with one half of B6 plain at a time; (c) one counted step, exactly a B6 (B5)
    forward and backward per layer and B3's per application of the shared
    block, nothing else; (d) the s per step of ``SCAN_TRAIN_TIMED`` more
    steps, then one traced step.  Returns launches summed over (c) and
    (d)'s timed steps (reset before each path's counted step, read after
    its timed steps)."""
    import dataclasses

    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch import steps
    from repro_torch.training import OptConfig
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.optimizer import tree_leaves
    total: dict[str, int] = {}
    opt = OptConfig(**TRAIN_OPT)
    for function, depth, n_f32, f32_grad_rel, bf16_grad_ulps in SCAN_TRAIN:
        cfg = ARCHS[function]
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in steps.make_batch(
            cfg, TRAIN_SEQ, TRAIN_BATCH, "train", SEED).items()}
        t0 = time.perf_counter()
        params = steps.init_params(cfg, SEED, DEVICE)
        sync()
        init_s = time.perf_counter() - t0
        n_params = sum(t.numel() for _, t in tree_leaves(params))
        # zamba2's bf16 step also with one half of B6 plain at a time, to
        # show which kernel moves its gradients
        variants = ({"b6_forward_kernel_plain_backward": lambda: ssd_halves(True),
                     "plain_forward_b6_backward_kernel": lambda: ssd_halves(False)}
                    if cfg.family == "hybrid" else None)
        kernel_vs_plain(cfg, params, batch, n_f32, t_start,
                        gate_bf16=bf16_grad_ulps is not None,
                        bf16_grad_ulps=bf16_grad_ulps or TRAIN_GRAD_ULPS,
                        remat_bf16=True, f32_grad_rel=f32_grad_rel,
                        extra={"params": n_params, "init_s": init_s,
                               "reduced": REDUCED.get(f"{function}/train")},
                        variants=variants)
        torch.cuda.empty_cache()
        per_step = scan_train_launches(cfg)
        state = opt_lib.init_state(params, opt)
        train_step, params, state = counted_step(cfg, params, state, batch, opt, per_step)
        times = []
        for _ in range(SCAN_TRAIN_TIMED):
            sync()
            t0 = time.perf_counter()
            params, state, metrics = train_step(params, state, batch)
            sync()
            times.append(time.perf_counter() - t0)
        launches = dict(LAUNCHES)
        want = {k: 0 for k in launches}
        want.update({k: n * (1 + SCAN_TRAIN_TIMED) for k, n in per_step.items()})
        losses_finite = math.isfinite(float(metrics["loss"]))
        profile = profile_forward(
            lambda: train_step(params, state, batch), iters=2,
            kernels={k: DEVICE_KERNELS[k] for k in per_step})
        emit({"phase": "train_path", "step": "train_step_profile", "function": function,
              "t": time.perf_counter() - t_start, "s_per_step": sum(times) / len(times),
              "step_s": times, "loss": float(metrics["loss"]), "launches": launches,
              **profile})
        if launches != want or not losses_finite:
            raise AssertionError(f"{function} train steps: launches {launches}, want "
                                 f"{want}; loss {float(metrics['loss'])}")
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        del params, state, metrics, train_step
        torch.cuda.empty_cache()
    return total


# -- phase 6: MoE invocation ---------------------------------------------------

MOE_FUNCTION, MOE_LAYERS = "deepseek-moe-16b", 3
MOE_REQUEST, MOE_SEEDS = (1, 16), (1, 999)      # tests/test_system.py:82


def phase_moe_invocation(t_start: float) -> dict:
    """deepseek-moe-16b at full width and ``MOE_LAYERS`` layers (its leading
    dense layer and two MoE groups): build its snapshot, then run one
    invocation on the card for each of two requests, each on a fresh
    ``InstanceArena``: the executor faults the dense params, routes each
    group on the true activations and faults only its routed experts'
    pages.  Gates: the expert pages faulted are exactly the routed experts'
    pages; the two requests' expert pages differ or are fewer than all;
    the cold logits equal a warm forward's over ``init_params`` bitwise (an
    untied head reads no unfaulted row); B3 launches ``MOE_LAYERS`` times
    an invocation.  Returns the phase's launches."""
    import dataclasses
    import shutil
    import tempfile

    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.core.arena import PAGE, GuestMemoryFile, InstanceArena
    from repro_torch.core.executor import run_invocation
    from repro_torch.core.snapshot import build_instance_snapshot
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import steps
    from repro_torch.models import moe
    cfg = dataclasses.replace(ARCHS[MOE_FUNCTION], n_layers=MOE_LAYERS)
    reduced = {"n_layers": [ARCHS[MOE_FUNCTION].n_layers, MOE_LAYERS],
               "why": "the arena at full depth (~230 GB) outgrows the card "
                      "machine's 75 GB of disk"}
    total: dict[str, int] = {}

    def line(**kw):
        emit({"phase": "moe_invocation", "t": time.perf_counter() - t_start, **kw})

    def count():
        for k, n in LAUNCHES.items():
            total[k] = total.get(k, 0) + n
        reset_launches()
    store = tempfile.mkdtemp(prefix="moe_store_", dir=os.path.join(ROOT, "build"))
    base = os.path.join(store, MOE_FUNCTION)
    try:
        t0 = time.perf_counter()
        with host_peak({}) as peak:
            gm = build_instance_snapshot(cfg, base, seed=SEED)
        line(step="snapshot", function=MOE_FUNCTION, n_layers=cfg.n_layers,
             d_model=cfg.d_model, reduced=reduced, seconds=time.perf_counter() - t0,
             arena_bytes=gm.layout.total_bytes, host_peak_gb=peak["host_peak_gb"])
        banks = [gm.layout.entries[f"params/groups/moe_layer/moe/{n}"]
                 for n in ("wi_gate", "wi_up", "wo")]

        def expert_pages(g: int, e: int) -> set:
            out = set()
            for b in banks:
                per = b.nbytes // (b.shape[0] * b.shape[1])
                lo = b.offset + (g * b.shape[1] + e) * per
                out.update(range(lo // PAGE, (lo + per - 1) // PAGE + 1))
            return out
        n_groups = moe.n_groups(cfg)
        all_expert = set().union(*(expert_pages(g, e) for g in range(n_groups)
                                   for e in range(cfg.n_experts)))
        seen, runs = [], []
        routed_experts = moe.routed_experts

        def recording(p, x, c):
            ids = routed_experts(p, x, c)
            seen.append(sorted(set(ids.reshape(-1).tolist())))
            return ids
        for seed in MOE_SEEDS:
            batch = steps.make_batch(cfg, MOE_REQUEST[1], MOE_REQUEST[0], "train", seed)
            arena = InstanceArena(GuestMemoryFile.open(base))
            seen.clear()
            count()
            moe.routed_experts = recording
            try:
                logits, seconds = run_invocation(cfg, arena, batch, device=DEVICE)
                sync()
            finally:
                moe.routed_experts = routed_experts
                arena.close()
            launches = dict(LAUNCHES)
            count()
            stats = arena.stats
            trace = set(stats.trace)
            routed = list(seen)
            want = set().union(*(expert_pages(g, e) for g, ids in enumerate(routed)
                                 for e in ids))
            faulted = trace & all_expert
            line(step="invocation", seed=seed, request=list(MOE_REQUEST),
                 seconds=seconds, n_faults=stats.n_faults, fault_s=stats.fault_seconds,
                 ws_pages=len(trace), expert_pages=len(faulted),
                 all_expert_pages=len(all_expert),
                 routed_per_group=[len(ids) for ids in routed],
                 expert_pages_per_group=[len(faulted & set().union(
                     *(expert_pages(g, e) for e in range(cfg.n_experts))))
                     for g in range(n_groups)],
                 launches=launches)
            check_logits(f"moe_invocation {seed}", logits,
                         (*MOE_REQUEST, cfg.vocab))
            if len(routed) != n_groups or faulted != want:
                raise AssertionError(f"moe_invocation {seed}: {len(faulted)} expert pages "
                                     f"faulted, the routed experts have {len(want)}")
            if launches["flash_attention"] != cfg.n_layers or any(
                    n for k, n in launches.items() if k != "flash_attention"):
                raise AssertionError(f"moe_invocation {seed}: launches {launches}, want "
                                     f"{cfg.n_layers} flash_attention")
            runs.append({"seed": seed, "batch": batch, "logits": logits,
                         "routed": routed, "pages": faulted})
        a, b = runs
        line(step="overlap", routed_common_per_group=[
                 len(set(x) & set(y)) for x, y in zip(a["routed"], b["routed"])],
             expert_pages_common=len(a["pages"] & b["pages"]),
             expert_pages_union=len(a["pages"] | b["pages"]))
        if a["pages"] == b["pages"] and len(a["pages"]) == len(all_expert):
            raise AssertionError("moe_invocation: both requests faulted every expert page")
        t0 = time.perf_counter()
        params = steps.init_params(cfg, SEED, DEVICE)
        forward = steps.build_forward(cfg)
        equal = []
        for r in runs:
            warm = forward(params, r["batch"])
            equal.append(bool(torch.equal(warm, r["logits"])))
            line(step="warm_forward", seed=r["seed"], cold_eq_warm=equal[-1],
                 max_abs=float((warm.float() - r["logits"].float()).abs().max()))
        count()
        line(step="done", warm_seconds=time.perf_counter() - t0, launches=total)
        if not all(equal):
            raise AssertionError("moe_invocation: cold logits differ from a warm forward's")
        del params
    finally:
        shutil.rmtree(store, ignore_errors=True)
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
        # no TPU counterpart: the JAX model differentiates its plain chunked
        # attention (no pallas_call has a backward)
        "flash_attention_bwd": (src + "flash_attention.cu",
                                "src/repro/nn/layers.py:142"),
        "decode_attention": (src + "decode_attention.cu",
                             tpu + "decode_attention/kernel.py:87"),
        "ssd_scan": (src + "mamba2_scan.cu", tpu + "mamba2_scan/kernel.py:71"),
        "wkv6_scan": (src + "rwkv6_scan.cu", tpu + "rwkv6_scan/kernel.py:80"),
        # no TPU counterpart either: the JAX model differentiates its plain
        # chunked scans
        "ssd_scan_bwd": (src + "mamba2_scan.cu", "src/repro/models/mamba2.py:84"),
        "wkv6_scan_bwd": (src + "rwkv6_scan.cu", "src/repro/models/rwkv6.py:106"),
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
    examples_launches = phase_examples_path(t_start)
    emit({"phase": "launch_counts", "path": "examples",
          "kernel_launches": examples_launches})
    reset_launches()
    moe_launches = phase_moe_invocation(t_start)
    emit({"phase": "launch_counts", "path": "moe_invocation",
          "kernel_launches": moe_launches})
    decode_launches = phase_decode_paths(t_start)
    emit({"phase": "launch_counts", "path": "decode", "kernel_launches": decode_launches})
    train_launches = phase_train_path(t_start)
    emit({"phase": "launch_counts", "path": "train", "kernel_launches": train_launches})
    scan_launches = phase_scan_train_paths(t_start)
    emit({"phase": "launch_counts", "path": "train_scans", "kernel_launches": scan_launches})
    launches = {k: n + fleet_launches.get(k, 0) + examples_launches.get(k, 0)
                + moe_launches.get(k, 0)
                + decode_launches.get(k, 0) + train_launches.get(k, 0)
                + scan_launches.get(k, 0) for k, n in launches.items()}
    emit({"phase": "done", "seconds": time.perf_counter() - t_start,
          "flash_library_kernels": rows["flash_attention"]["library_kernels"]})
    print(env["nvidia_smi"], flush=True)
    emit({"kernels": kernel_table(rows, launches)})
    emit({"ok": True, "device": {"platform": "gpu", "kind": env["device"],
                                 "count": env["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
