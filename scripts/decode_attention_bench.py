"""Times B4 (``gqa_decode``) on the card at ``chip_smoke.py``'s decode
shapes (``DECODE_CASES``): each case through ``chip_smoke.check_decode``
(error against the plain version, two calls bitwise, SDPA's device ms,
the bound) and its device ms by kernel (``PARTS``), then, with ``--sweep``, the device ms of the
bfloat16 cases at each given split count and the wrapper's own, timed in
turns, back to back and with the L2 cache flushed (SDPA's too), for the built
kernel and for each ``--variant``: a copy of ``csrc/decode_attention.cu``
with some of its ``constexpr int`` tuning constants changed (e.g.
``s3:kStages=3``, ``w8:kWarps=8``), built beside it under
``build/decode_variants/``.  One JSON line per case, then the card's name
and power limit.

    python3 scripts/decode_attention_bench.py [--root DIR] [--sweep 1,4,16|chosen]
        [--variant LABEL:NAME=VALUE[,NAME=VALUE]]... [--label NAME] [--out FILE]

``--root`` names the checkout whose ``src/repro_torch`` is timed (default:
this one), so that two versions, e.g. a parent commit unpacked with
``git archive`` into ``build/``, run in one call with the same harness.
Needs one CUDA card and nvcc; builds under ``<root>/build/repro_torch/``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# B4's device kernels by the part each computes: the key ranges' partial
# softmax (whose last CTA of a (b, KV head) merges the ranges), and a
# separate merge kernel where a build has one (``decode_combine`` before
# the merge was folded into ``decode_split``)
PARTS = {"split": r"decode_split", "merge": r"decode_(merge|combine)"}


def build_variants(build, specs: list[str]) -> dict:
    """label -> the bound library of each variant of decode_attention.cu."""
    out = build.BUILD_ROOT.parent / "decode_variants"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    for header in build.CSRC.glob("*.cuh"):
        shutil.copy(header, out)
    src = (build.CSRC / "decode_attention.cu").read_text()
    procs = {}
    for spec in specs:
        label, assigns = spec.split(":", 1)
        text = src
        for assign in assigns.split(","):
            name, value = assign.split("=")
            text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                              text)
            if n != 1:
                raise SystemExit(f"{spec}: want one 'constexpr int {name} = ...;'")
        (out / f"decode_{label}.cu").write_text(text)
        procs[label] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out / f"libdecode_{label}.so"),
             str(out / f"decode_{label}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    libs = {}
    for label, proc in procs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise SystemExit(f"{label}: nvcc failed\n{log[-3000:]}")
        lib = ctypes.CDLL(str(out / f"libdecode_{label}.so"))
        for fn, argtypes in build.SIGNATURES["decode_attention"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[label] = lib
    return libs


def inputs(case):
    """q, k, v and the valid lengths of one ``DECODE_CASES`` row on the card."""
    import numpy as np
    import torch
    B, S, H, KV, D, dtype, kv_len = case
    rng = np.random.default_rng(S * 100 + H)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               .to("cuda", getattr(torch, dtype))
               for s in ((B, 1, H, D), (B, S, KV, D), (B, S, KV, D)))
    lens = torch.full((B,), S if kv_len is None else kv_len, dtype=torch.int32,
                      device="cuda")
    return q, k, v, lens


def by_kernel(case) -> dict:
    """Device ms a call of one case by part (``PARTS``), back to back."""
    import chip_smoke
    from repro_torch.kernels.decode_attention import gqa_decode
    q, k, v, lens = inputs(case)
    return chip_smoke.device_ms_by_part(lambda: gqa_decode(q, k, v, lens), PARTS, calls=10)


def sweep(case, splits: list[int]) -> dict:
    """Device ms of one bfloat16 case at each split count and at the
    wrapper's own (its ``n_splits`` replaced), each output held to the
    plain version: back to back (``device_ms``; a cache of up to the
    L2's 50 MB stays there in part from call to call) and after a
    256 MB read before each call (``cold_device_ms``: the cache comes
    from HBM, as in a decode step, where the other layers' weights and
    caches pass through L2 between two calls)."""
    import torch

    import chip_smoke
    from repro_torch.kernels.decode_attention import gqa_decode, gqa_decode_ref, ops
    B, S, H, KV, D, dtype, kv_len = case
    q, k, v, lens = inputs(case)
    ref = gqa_decode_ref(q, k, v, lens).float()
    atol = chip_smoke.KERNEL_ULPS * chip_smoke.bf16_ulp(ref)
    chosen = ops.n_splits
    splits = sorted({*splits, chosen(B, KV, S)})
    flush = torch.zeros(64 << 20, dtype=torch.float32, device="cuda")

    def cold():
        flush.sum()                     # 256 MB read: evicts the cache, leaves L2 clean
        return gqa_decode(q, k, v, lens)
    mask = (torch.arange(S, device="cuda")[None, :] < lens[:, None])[:, None, None, :]

    def sdpa_cold():
        flush.sum()
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
            enable_gqa=H != KV)
    # SDPA's own kernels: all but the flush's
    sdpa_ms = chip_smoke.device_ms_by_part(sdpa_cold, {"flush": r"reduce_kernel"},
                                           calls=10)["other"]
    errs: dict[int, float] = {}
    seen: dict[int, list] = {n: [] for n in splits}
    seen_cold: dict[int, list] = {n: [] for n in splits}
    try:
        for n in splits + splits[::-1]:
            ops.n_splits = lambda *_a, n=n: n
            errs[n] = float((gqa_decode(q, k, v, lens).float() - ref).abs().max())
            seen[n].append(chip_smoke.device_profile(lambda: gqa_decode(q, k, v, lens))[1])
            parts = chip_smoke.device_ms_by_part(cold, PARTS, calls=10)
            seen_cold[n].append(parts["split"] + parts["merge"])
    finally:
        ops.n_splits = chosen
    del flush
    return {"shape": [B, S, H, KV, D], "dtype": dtype, "kv_len": kv_len,
            "chosen": chosen(B, KV, S), "atol": atol, "sdpa_cold_device_ms": sdpa_ms,
            "by_split": {n: {"device_ms": sum(seen[n]) / 2,
                             "cold_device_ms": sum(seen_cold[n]) / 2,
                             "max_abs_err": errs[n], "ok": errs[n] <= atol} for n in splits}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--sweep", default="",
                    help="comma-separated split counts ('chosen': the wrapper's alone)")
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("decode_attention_bench: no usable CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    from repro_torch.kernels import build
    for stem in build.build_all():
        build.library(stem)
    lines = []

    def emit(obj):
        obj = {"label": args.label, **obj}
        lines.append(obj)
        print(json.dumps(obj), flush=True)
    for case in chip_smoke.DECODE_CASES:
        emit({"case": "check", **chip_smoke.check_decode(*case),
              "kernel_device_ms_by_kernel": by_kernel(case)})
    splits = [int(x) for x in args.sweep.split(",") if x.isdigit()]
    built = build.library("decode_attention")
    variants = {"built": built, **build_variants(build, args.variant)}
    for variant, lib in variants.items():
        build._LIBS["decode_attention"] = lib
        for case in chip_smoke.DECODE_CASES if args.sweep else ():
            if case[5] == "bfloat16":
                emit({"case": "sweep", "variant": variant, **sweep(case, splits)})
    build._LIBS["decode_attention"] = built
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for obj in lines:
                f.write(json.dumps({**obj, "nvidia_smi": smi}) + "\n")
    return 0 if all(o.get("ok", True) for o in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
