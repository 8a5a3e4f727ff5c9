#!/usr/bin/env python3
"""Run one cell once, traced, with the program's span recording on::

    python3 portbench/spanrun.py --workload <name> --seed <n> --seconds <s>

It is ``run.py --trace 1``: the same set-up, window, device trace, readers
and check, with the program's span recording (``repro_torch.telemetry``)
switched on before set-up, so the prewarm is traced too, and off after the
window. The run's record gains ``spans`` (every finished trace, as dicts)
and its trace the attribution of the device's kernels to the program's
spans (``spans.reduce``); the result line gains the span metrics
(``METRICS``), and a ``spans`` breakdown: the attributed share, device ms
of a warm invocation by op, and the idle gaps labelled with the host's
phases. ``run.py`` itself records no span.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the readers of the program's spans (``metrics/<name>.py``)
METRICS = [("dispatch_ms.warm", "ms"), ("sync_wait_ms.warm", "ms"),
           ("forward_device_ms.warm", "ms"), ("eager_ms.warm", "ms"),
           ("prewarm_fault_s.warm", "s")]


def window(sut, seconds: float) -> dict:
    """``harness.System.window`` traced, with the spans' reduction."""
    import torch
    from repro_torch.telemetry import TELEMETRY

    from portbench import harness, spans, trace
    ctx, state = sut.ctx, {}

    def window_start():
        state["tracing"] = trace.Tracing()
        return time.perf_counter()

    ctx["window_start"] = window_start
    try:
        recs, t0, close, samples = harness.warm_window(ctx, seconds)
        TELEMETRY.stop_tracing()
        processing = [(r["done"] - r["processing_s"], r["done"]) for r in recs
                      if r.get("processing_s") is not None and r["done"] is not None]
        tr = state.pop("tracing")
        trace_rec = trace.stop(tr, processing, close)
        traces = [t.to_dict() for t in TELEMETRY.drain_traces()]
        t = time.perf_counter()
        kernels, launches = spans.device_activity(tr)
        add = spans.reduce(kernels, launches, traces, processing, tr.t_start, close)
        trace_rec.update({k: v for k, v in add.items() if k != "idle_gaps"},
                         idle_gaps_by_phase=add["idle_gaps"],
                         launches_seen=len(launches), reduce_s=time.perf_counter() - t)
    finally:
        if "tracing" in state:
            state["tracing"].prof.stop()
    return {"requests": recs, "window_start": t0, "seconds": seconds,
            "result_wait_s": harness.RESULT_WAIT_S, "trace": trace_rec,
            "config": ctx["conf"], "mix": ctx["mix"], "samples": samples,
            "spans": traces,
            "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                  if sut.dev.type == "cuda" else 0)}


def run(c: dict, *, seed: int, seconds: float, t_start: float,
        device: str = "cuda", out: str | None = None) -> dict:
    """``harness.run_cell`` with ``trace=True`` and span recording on;
    ``out`` names a file for the run's traces and invocation records."""
    import json

    from repro_torch.telemetry import TELEMETRY

    from portbench import harness, readers
    TELEMETRY.drain_traces()
    TELEMETRY.start_tracing()
    try:
        sut = harness.System(c, seed=seed, device=device)
        try:
            rec = window(sut, seconds)
            rec["setup_s"] = rec["window_start"] - t_start
            stats = harness.counts_of(rec["requests"])
            harness.emit({"phase": "window", "requests": len(rec["requests"]), **stats,
                          "setup_stages": sut.ctx["stages"], "setup_s": rec["setup_s"]})
        finally:
            sut.close()
    finally:
        TELEMETRY.stop_tracing()
    per_layer = c["per_layer"] + [{"name": n, "unit": u} for n, u in METRICS]
    metrics = harness.read_metrics(dict(c, per_layer=per_layer), rec, "per_layer")
    tr = rec["trace"]
    n = sum(readers.window_share(rec, r) for r in readers.served(rec) if not r["cold"])
    by_op = {k: v / n * 1e3 for k, v in sorted(tr["device_s_by_op"].items(),
                                                key=lambda kv: -kv[1])} if n else {}
    harness.emit({"phase": "spans", "attributed_share": tr["attributed_share"],
                  "device_ms_by_op": by_op, "traces": len(rec["spans"]),
                  "launch_call_ms": tr["launch_call_s"] / n * 1e3 if n else None,
                  "launches_seen": tr["launches_seen"], "reduce_s": tr["reduce_s"]})
    if out is not None:
        with open(out, "w") as f:
            json.dump({"spans": rec["spans"], "requests": rec["requests"],
                       "window_start": rec["window_start"]}, f)
    check = harness.compare(sut.ctx, rec["samples"])
    compared = {
        "logit_err": {"value": check["logit_err"], "limit": c["cell"]["limits"]["logit_err"]},
        "failed": {"value": stats["failed"], "limit": 0},
        "cold_invocations": {"value": stats["cold"], "limit": 0},
    }
    return {"correct": all(v["value"] <= v["limit"] for v in compared.values()),
            "attempted": len(rec["requests"]), "failed": stats["failed"],
            "metrics": metrics,
            "device": {"kind": sut.dev.type, "memory_peak_bytes": rec["memory_peak_bytes"],
                       "busy_s": tr["busy_s"], "window_s": tr["window_s"]},
            "breakdown": {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"],
                          "idle_gaps_by_phase": tr["idle_gaps_by_phase"],
                          "device_ms_by_op": by_op},
            "compared": compared}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", help="a JSON file for the traces and the invocations")
    args = ap.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import json

    from portbench import harness, spec
    c = spec.cell(spec.load_benchmark(), args.workload)
    harness.emit({"phase": "environment", **harness.card(), "workload": args.workload,
                  "seed": args.seed, "seconds": args.seconds, "spans": True})
    result = run(c, seed=args.seed, seconds=args.seconds, t_start=T_START,
                 out=args.out)
    for name, v in result["compared"].items():
        print(f"compared {name}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
