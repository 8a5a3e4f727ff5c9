"""Times each scan kernel's routes at short lengths on the card: B6
``ssd_scan`` and B5 ``wkv6`` take a step kernel for a decode step (L = 1)
and their chunk kernel for longer scans.  This builds copies of the two
sources with that dispatch forced one way ("chunks": the chunk kernel at
every L; "steps": B5's step kernel at every L) beside the repo's own
build, holds every route to the plain version, and prints each route's
device milliseconds a call (profiler, timed in turns), one JSON line per
shape, then the card's name and power limit.

    PYTHONPATH=src python3 scripts/scan_decode_routes.py

Needs one CUDA card and nvcc; writes only under ``build/scan_routes/``.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

DISPATCH = "if (L == 1) {"              # the step kernel's branch in both sources
VARIANTS = {"mamba2_scan": {"chunks": "if (false) {"},
            "rwkv6_scan": {"chunks": "if (false) {", "steps": "if (true) {"}}
# (kernel, L, dtype) at the main paths' decode widths: zamba2-1.2b
# (4 rows, 64 heads, P = N = 64) and rwkv6-7b (4 rows, 64 heads, D 64)
CASES = [("ssd", 1, "bfloat16"), ("ssd", 1, "float32"),
         *[("wkv", L, "bfloat16") for L in (1, 2, 4, 8, 15)], ("wkv", 1, "float32")]


def build_variants(build) -> dict:
    out = ROOT / "build" / "scan_routes"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    for header in build.CSRC.glob("*.cuh"):
        shutil.copy(header, out)
    procs = {}
    for stem, routes in VARIANTS.items():
        src = (build.CSRC / f"{stem}.cu").read_text()
        if src.count(DISPATCH) != 1:
            raise SystemExit(f"{stem}.cu: want one '{DISPATCH}'")
        for route, branch in routes.items():
            (out / f"{stem}_{route}.cu").write_text(src.replace(DISPATCH, branch))
            procs[stem, route] = subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out / f"lib{stem}_{route}.so"),
                 str(out / f"{stem}_{route}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    libs = {}
    for (stem, route), proc in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise SystemExit(f"{stem} {route}: nvcc failed\n{log[-3000:]}")
        lib = ctypes.CDLL(str(out / f"lib{stem}_{route}.so"))
        for fn, argtypes in build.SIGNATURES[stem].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[stem, route] = lib
    return libs


def inputs(kernel: str, L: int, dtype: str):
    import numpy as np
    import torch
    rng = np.random.default_rng(L)

    def r(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * scale
                                ).to("cuda")
    dt = getattr(torch, dtype)
    if kernel == "ssd":
        return (r(4, L, 64, 64).to(dt), r(4, L, 64, scale=0.1).abs(), -r(64).abs(),
                r(4, L, 64, scale=0.3), r(4, L, 64, scale=0.3), r(4, 64, 64, 64, scale=0.1))
    return (r(4, L, 64, 64).to(dt), r(4, L, 64, 64, scale=0.3).to(dt), r(4, L, 64, 64).to(dt),
            -r(4, L, 64, 64, scale=0.5).abs() - 0.05, r(64, 64, scale=0.2),
            r(4, 64, 64, 64, scale=0.1))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("scan_decode_routes: no usable CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import device_profile
    from repro_torch.kernels import build
    from repro_torch.kernels.mamba2_scan import ssd_scan, ssd_scan_ref
    from repro_torch.kernels.rwkv6_scan import wkv6, wkv6_ref
    built = {stem: build.library(stem) for stem in VARIANTS}
    variants = build_variants(build)
    fns = {"ssd": ("mamba2_scan", ssd_scan, ssd_scan_ref),
           "wkv": ("rwkv6_scan", wkv6, wkv6_ref)}
    for kernel, L, dtype in CASES:
        stem, fn, ref = fns[kernel]
        args = inputs(kernel, L, dtype)
        ry, rs = ref(*args)
        routes = {"built": built[stem], **{route: variants[stem, route]
                                           for route in VARIANTS[stem]}}
        row = {"kernel": kernel, "L": L, "dtype": dtype}
        for route, lib in routes.items():
            build._LIBS[stem] = lib
            y, s = fn(*args)
            row[f"{route}_err"] = max(float((y - ry).abs().max()), float((s - rs).abs().max()))
            row[f"{route}_finite"] = bool(torch.isfinite(y).all() and torch.isfinite(s).all())
            row[f"{route}_kernels"] = device_profile(lambda: fn(*args), calls=5)[0]
        seen: dict[str, list] = {route: [] for route in routes}
        for route in [*routes, *reversed(routes)]:
            build._LIBS[stem] = routes[route]
            seen[route].append(device_profile(lambda: fn(*args), calls=50)[1])
        for route, ms in seen.items():
            row[f"{route}_us"] = 1e3 * sum(ms) / len(ms)
        build._LIBS[stem] = built[stem]
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
