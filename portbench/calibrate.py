#!/usr/bin/env python3
"""The two readings each correctness limit is set from, on the card::

    python3 portbench/calibrate.py --workload <name> --program-seeds 1,2,... \\
        --control-seeds 7,8,9 [--seconds 10]

* program: for each seed a whole run of the cell (set-up, a window of
  ``--seconds`` of the cell's closed loop, the same sample and comparison as
  ``run.py``), one JSON line each: the widest logit error and argmax gap;
* control: for each seed, the reference computed with its matrix
  products' operands in float8 e4m3 (the step below the bfloat16 the
  configurations state) in the program's place, on the invocations a run
  of the seed samples, held to the float32 reference: the same two numbers.

The limit of ``cells/<workload>.json`` lies between the largest program
reading and the smallest control reading (``PERF.md`` gives both).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

if __package__ in (None, ""):
    ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

from portbench import harness, spec, traffic  # noqa: E402


def program_reading(c: dict, seed: int, seconds: float, device: str) -> dict:
    sut = harness.System(c, seed=seed, device=device)
    try:
        rec = sut.window(seconds, False)
    finally:
        sut.close()
    out = harness.compare(sut.ctx, rec["samples"])
    out.update(harness.counts_of(rec["requests"]))
    return out


def control_reading(c: dict, seed: int, device: str) -> dict:
    """The control on the invocations a run of the seed samples."""
    conf, mix = c["config"], c["mix"]
    ctx = {"conf": conf, "cfg": harness.port_config(conf), "seed": seed,
           "device": torch.device(device)}
    keep = traffic.sample(mix, seed)
    seq = traffic.Sequence(mix, seed, conf["vocab"])
    batches = [seq.next() for _ in range(max(keep) + 1)]
    samples = [(batch, None) for k, batch in batches if k in keep]
    return harness.compare(ctx, samples, precision="fp8")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args()
    c = spec.cell(spec.load_benchmark(), args.workload)
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    seeds = {k: [int(s) for s in v.split(",") if s] for k, v in
             (("control", args.control_seeds), ("program", args.program_seeds))}
    readings = {"control": [], "program": []}
    for seed in seeds["control"]:
        r = control_reading(c, seed, dev)
        readings["control"].append(r)
        harness.emit({"reading": "control", "workload": args.workload, "seed": seed, **r})
    for seed in seeds["program"]:
        r = program_reading(c, seed, args.seconds, dev)
        readings["program"].append(r)
        harness.emit({"reading": "program", "workload": args.workload, "seed": seed, **r})
    summary = {k: {m: [r[m] for r in v] for m in ("logit_err", "argmax_gap")}
               for k, v in readings.items() if v}
    harness.emit({"summary": args.workload, **summary,
                  "program_max": {m: max(x) for m, x in summary.get("program", {}).items()},
                  "control_min": {m: min(x) for m, x in summary.get("control", {}).items()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
