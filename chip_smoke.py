#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each (any failure raises and exits non-zero):

1. environment: the card, its power limit (``nvidia-smi``) and versions;
2. build: every kernel of ``src/repro_torch/csrc`` compiled with ``nvcc``
   for ``sm_90a`` (into ``build/repro_torch/``);
3. kernel checks: each kernel against its plain PyTorch version on the
   card at the main path's shapes, with its time, the plain version's,
   one library call's (a yardstick the port never calls) and its bound;
4. main path: full-width olmo-1b served through ``Orchestrator`` and
   ``Router`` -- register, a record request, scale to zero, a single cold
   start, a group restore of two, warm requests -- with the logits held
   to each other and to the plain versions on the card;
5. the launch counts of the main path, the kernel table, and the last
   line ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when no CUDA device is usable, or when the
port's sources are not beside this file.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}   # dense, no sparsity
FLASH_CASES = [                      # (B, S, H, KV, D, dtype)
    (2, 256, 4, 2, 64, "float32"),   # the four shapes of tests/test_kernels.py
    (1, 128, 8, 8, 128, "float32"),
    (2, 384, 6, 2, 80, "float32"),
    (1, 256, 4, 1, 64, "bfloat16"),
    (1, 64, 16, 16, 128, "bfloat16"),     # olmo-1b, the serving request
    (1, 2048, 16, 16, 128, "bfloat16"),   # olmo-1b, a long prompt
]
FLASH_ATOL = {"float32": 2e-5, "bfloat16": 2e-2}


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
    res = {"kernel": "gather_pages", "n": n, "row_bytes": row_bytes,
           "byte_exact": exact, "max_abs_err": 0.0 if exact else float("nan"),
           "kernel_ms": cuda_ms(lambda: gather_pages(table, idx), iters),
           "plain_ms": cuda_ms(lambda: page_gather_ref(table, idx), iters),
           "library_ms": cuda_ms(lambda: torch.index_select(table, 0, idx), iters),
           "bound_ms": b, "bound_by": by}
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
    res = {"kernel": "scatter_pages", "n": n, "row_bytes": row_bytes,
           "byte_exact": exact, "max_abs_err": 0.0 if exact else float("nan"),
           "kernel_ms": cuda_ms(lambda: scatter_pages(ws, idx, dest), iters),
           "plain_ms": cuda_ms(lambda: page_scatter_ref(ws, idx, dest), iters),
           "library_ms": cuda_ms(lambda: dest.index_copy_(0, idx, ws), iters),
           "bound_ms": b, "bound_by": by}
    del ws, base, dest
    torch.cuda.empty_cache()
    return res


def check_flash(B: int, S: int, H: int, KV: int, D: int, dtype: str) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention_ref, mha
    rng = np.random.default_rng(S * 1000 + H)
    tdt = getattr(torch, dtype)

    def r(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to("cuda", tdt)
    q, k, v = r(B, S, H, D), r(B, S, KV, D), r(B, S, KV, D)

    def plain():
        return flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2)).transpose(1, 2)

    def library():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=H != KV)
    out = mha(q, k, v)
    ref = plain()
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    iters = 20 if S <= 512 else 5
    n_bytes = (q.numel() * 2 + k.numel() * 2) * q.element_size()
    n_ops = 4 * B * H * D * S * (S + 1) // 2     # QK^T and PV, causal half
    b, by = bound_ms(n_bytes, n_ops, dtype)
    return {"kernel": "flash_attention", "shape": [B, S, H, KV, D],
            "dtype": dtype, "max_abs_err": err, "atol": FLASH_ATOL[dtype],
            "ok": err <= FLASH_ATOL[dtype],
            "kernel_ms": cuda_ms(lambda: mha(q, k, v), iters),
            "plain_ms": cuda_ms(plain, iters),
            "library_ms": cuda_ms(library, iters),
            "bound_ms": b, "bound_by": by}


def phase_kernel_checks(ws_pages: int) -> dict:
    """Each kernel against its plain version; returns the main-path rows."""
    rows = {}
    for n, row_bytes, main in ((ws_pages, 4096, True), (10_000, 4100, False)):
        for fn in (check_gather, check_scatter):
            res = fn(n, row_bytes, iters=5 if main else 20)
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
        if case[:5] == (1, 64, 16, 16, 128):
            rows["flash_attention"] = res
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


def plain_attention(q, k, v):
    """The flash kernel's plain version, in the model's (B, S, H, D) layout."""
    from repro_torch.kernels.flash_attention import flash_attention_ref
    return flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2)).transpose(1, 2)


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


def profile_forward(fn, iters: int = 5) -> dict:
    """Host milliseconds of one synchronised call, and the device's busy
    milliseconds in one call from torch.profiler (None when the profiler
    sees no device time)."""
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
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    busy_ms = sum(getattr(e, "self_device_time_total", 0) for e in events) / 1e3
    top = sorted(events, key=lambda e: -getattr(e, "self_device_time_total", 0))[:5]
    return {"calls": iters + 2, "wall_ms": wall_ms, "device_busy_ms": busy_ms or None,
            "device_idle_share": 1 - busy_ms / wall_ms if busy_ms else None,
            "top_device_ms": {e.key[:60]: getattr(e, "self_device_time_total", 0) / 1e3
                              for e in top}}


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
        cold_plain = forward(cfg, params, batch, attn=plain_attention)
        del params
        cold_err = float((cold.float() - cold_plain.float()).abs().max())

        for inst in group:
            inst.make_warm()
        warm = [request(f"warm_{i}")[0] for i in range(3)]
        prof = profile_forward(lambda: forward(cfg, group[0]._warm_params, batch))
        line(step="warm_forward_profile", **prof)
        warm_plain = forward(cfg, group[0]._warm_params, batch, attn=plain_attention)
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
                "forwards": forwards}
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


def kernel_table(rows: dict, launches: dict) -> list[dict]:
    src = "src/repro_torch/csrc/"
    meta = {
        "gather_pages": (src + "page_gather.cu",
                         "src/repro/kernels/page_gather/kernel.py:27"),
        "scatter_pages": (src + "page_gather.cu",
                          "src/repro/kernels/page_gather/kernel.py:56"),
        "flash_attention": (src + "flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:59"),
    }
    out = []
    for name, (source, replaces) in meta.items():
        r = rows[name]
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
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
        emit({"phase": "launch_counts", "kernel_launches": launches,
              "forwards": n_forwards})
        phase_fuse_engines(main_res["base"])
    finally:
        shutil.rmtree(store, ignore_errors=True)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(env["nvidia_smi"], flush=True)
    emit({"kernels": kernel_table(rows, launches)})
    emit({"ok": True, "device": {"platform": "gpu", "kind": env["device"],
                                 "count": env["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
