"""One run of one cell: set-up, the measured window, the reading of its
metrics, and the check of what the timed path produced.

The system under test is the port's serving entry, ``Router.submit`` ->
``Orchestrator.invoke`` -> ``FunctionInstance.invoke``, with
``ServeConfig()``'s defaults. Set-up writes the function's image, makes
the mix's number of instances warm through ``Orchestrator.prewarm``
(restoring in the mix's ``serve_config`` mode: ``vanilla``, since a
prewarm without a record writes one record an instance, 1,329 s for eight
on the H100's host) and warms up each of the mix's shapes. The window is
a closed loop (``traffic.Sequence``): the mix's callers each send their
next invocation when the last returns, until the window's time is up,
and then wait for what they sent; latency runs from the send to the
result. A cold invocation in the window fails
the run.

After the window the device's peak memory is read, the program's state is
freed, and the reference recomputes a sample of the window's invocations
(drawn from the seed, the longest among them) in float32 from the
benchmark's own weights; each number compared is printed beside its limit.
"""
from __future__ import annotations

import gc
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from . import spec, traffic
from . import trace as tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
RESULT_WAIT_S = 60.0                 # how long past the close an answer may come


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def stage(ctx: dict, name: str, t: float, **more) -> None:
    """Record and print one set-up stage's seconds as it ends."""
    ctx["stages"][name] = time.perf_counter() - t
    ctx["stages"].update(more)
    emit({"phase": "setup", "stage": name, "seconds": ctx["stages"][name], **more})


def loaded_forbidden(modules=None) -> list[str]:
    """Modules (default: this process's) whose top-level name is one the
    benchmark must never load, compared whole: ``repro_torch`` is not
    ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def bytes_written() -> int | None:
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("write_bytes:"):
                    return int(line.split()[1])
    except OSError:
        return None
    return None


def card() -> dict:
    """The card's name and power limit (``nvidia-smi``)."""
    out = {"name": torch.cuda.get_device_name(0)}
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        out["nvidia_smi"] = res.stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out["nvidia_smi"] = f"unavailable: {e}"
    return out


def port_config(conf: dict):
    """The port's configuration named by the file, checked to be the one
    the file describes (every number and name the two share)."""
    import dataclasses

    from repro_torch.configs import ARCHS, SMOKES
    cfg = (SMOKES if conf.get("preset") == "smoke" else ARCHS)[conf["port_config"]]
    port = dict(dataclasses.asdict(cfg), head_dim=cfg.resolved_head_dim)
    for k, v in port.items():
        if k in conf and k != "name" and conf[k] != v:
            raise ValueError(f"{conf['name']}: {k} is {conf[k]!r} in the file, "
                             f"{v!r} in the port")
    return cfg


def request_record(k: int, submit: float, batch: np.ndarray, done: float | None,
                   rep, error: str | None) -> dict:
    rec = {"i": k, "submit": submit, "batch": int(batch.shape[0]),
           "length": int(batch.shape[1]), "tokens": int(batch.size), "done": done,
           "error": error}
    if rep is not None:
        rec.update(queue_s=rep.queue_s, processing_s=rep.processing_s,
                   cold=rep.load_vmm_s > 0)
    return rec


# -- the closed loop ----------------------------------------------------------

def warm_setup(ctx: dict) -> None:
    """Make the mix's instances warm and warm up every shape of the mix on
    them."""
    mix, orch, router, name = ctx["mix"], ctx["orch"], ctx["router"], ctx["fn"]
    t = time.perf_counter()
    orch.prewarm(name, mix["instances"], wait=True)
    rec = orch.functions[name]
    if rec.n_prewarm_failures or orch.idle_count(name) != mix["instances"]:
        raise RuntimeError(f"prewarm: {orch.idle_count(name)} warm of {mix['instances']}, "
                           f"failure: {rec.last_prewarm_error!r}")
    stage(ctx, "prewarm_s", t)
    t = time.perf_counter()
    rng = np.random.default_rng(0)
    for L in mix["lengths"]:
        invs = [router.submit(name, {"tokens": traffic.tokens(rng, ctx["vocab"],
                                                              mix["batch"], L)})
                for _ in range(mix["instances"])]
        for inv in invs:
            _, rep = inv.result(600)
            if rep.load_vmm_s > 0:
                raise RuntimeError("a warm-up invocation started cold")
    stage(ctx, "warmup_s", t)


def warm_window(ctx: dict, seconds: float) -> tuple:
    """The closed loop. Returns the records, the window's start and close,
    and the sampled (tokens, output) pairs that came."""
    mix, router, name = ctx["mix"], ctx["router"], ctx["fn"]
    seq = traffic.Sequence(mix, ctx["seed"], ctx["vocab"])
    keep = traffic.sample(mix, ctx["seed"])
    recs, kept, lock = [], {}, threading.Lock()
    t0 = ctx["window_start"]()
    close = t0 + seconds
    deadline = close + RESULT_WAIT_S

    def caller():
        while time.perf_counter() < close:
            k, batch = seq.next()
            t = time.perf_counter()
            done = rep = out = err = None
            try:
                out, rep = router.submit(name, {"tokens": batch}).result(
                    max(deadline - t, 0.001))
                done = time.perf_counter()
                if out is None:
                    done, err = None, "no output"
            except Exception as e:          # a failed or missing answer is a result
                err = f"{type(e).__name__}: {e}"
            with lock:
                recs.append(request_record(k, t, batch, done, rep, err))
                if k in keep and out is not None:
                    kept[k] = (batch, out)

    callers = [threading.Thread(target=caller, name=f"portbench-caller-{j}", daemon=True)
               for j in range(mix["clients"])]
    for th in callers:
        th.start()
    for th in callers:
        th.join()
    recs.sort(key=lambda r: r["i"])
    return recs, t0, close, [kept[k] for k in sorted(kept)]


# -- correctness ----------------------------------------------------------------

def compare(ctx: dict, samples: list, precision: str = "f32") -> dict:
    """The widest logit error and the widest argmax gap of the program's
    outputs against the reference, over every sequence of the sample.
    ``precision`` other than f32 puts the reference in the program's
    place (the control)."""
    from .reference.common import exact_float32
    ref_mod = importlib.import_module(f"portbench.reference.{ctx['conf']['reference']}")
    from . import weights
    params = weights.params_f32(ctx["cfg"], ctx["seed"], ctx["device"])
    err = gap = 0.0
    n_tokens = 0
    with torch.no_grad(), exact_float32():
        for batch, out in samples:
            for b in range(batch.shape[0]):
                tok = torch.as_tensor(batch[b], device=ctx["device"]).long()
                ref = ref_mod.forward(ctx["conf"], params, tok)
                if precision == "f32":
                    got = out[b].to(ctx["device"]).float()
                else:
                    got = ref_mod.forward(ctx["conf"], params, tok, precision=precision)
                err = max(err, float((got - ref).abs().max()))
                picked = torch.gather(ref, 1, got.argmax(dim=1, keepdim=True))[:, 0]
                gap = max(gap, float((ref.max(dim=1).values - picked).max()))
                n_tokens += tok.numel()
                del ref, got
    del params
    return {"logit_err": err, "argmax_gap": gap, "tokens": n_tokens}


# -- one run ----------------------------------------------------------------------

class System:
    """A cell's system under test, set up once: the image, the
    orchestrator and router, the prewarm and the warm-up. ``window``
    measures; ``close`` stops every thread and frees the device."""

    def __init__(self, c: dict, *, seed: int, device: str):
        from repro_torch.serving import Orchestrator, Router, ServeConfig
        from . import weights

        conf, mix = c["config"], c["mix"]
        self.c = c
        self.dev = torch.device(device)
        self.ctx = ctx = {"conf": conf, "mix": mix,
                          "cfg": port_config(conf), "seed": seed, "device": self.dev,
                          "vocab": conf["vocab"], "fn": conf["name"], "stages": {}}
        self.w0 = bytes_written()
        self.store = tempfile.mkdtemp(prefix="portbench-")
        ctx["orch"] = ctx["router"] = None
        try:
            if self.dev.type == "cuda":
                from repro_torch.kernels import build_all
                t = time.perf_counter()
                build_all()
                stage(ctx, "kernels_s", t)
            t = time.perf_counter()
            nbytes = weights.write_image(ctx["cfg"], os.path.join(self.store, ctx["fn"]),
                                         seed, self.dev)
            stage(ctx, "image_s", t, image_bytes=nbytes)
            ctx["orch"] = Orchestrator(self.store, ServeConfig(
                device=device, **mix.get("serve_config", {})))
            t = time.perf_counter()
            ctx["orch"].register(ctx["fn"], ctx["cfg"], warmup_batch={"tokens": np.zeros(
                (mix["batch"], mix["lengths"][0]), dtype=np.int32)})
            stage(ctx, "register_s", t)
            ctx["router"] = Router(ctx["orch"])
            warm_setup(ctx)
            if self.dev.type == "cuda":
                torch.cuda.synchronize()
        except BaseException:
            self.close()
            raise

    def window(self, seconds: float, trace: bool) -> dict:
        """One measured window; returns the run's record (what the metric
        readers take) with the sampled outputs and the device's peak."""
        ctx = self.ctx
        state = {"tracing": None}

        def window_start():
            if trace:
                state["tracing"] = tracing.Tracing()
            return time.perf_counter()

        ctx["window_start"] = window_start
        try:
            recs, t0, close, samples = warm_window(ctx, seconds)
            processing = [(r["done"] - r["processing_s"], r["done"]) for r in recs
                          if r.get("processing_s") is not None and r["done"] is not None]
            trace_rec = tracing.stop(state["tracing"], processing, close) if trace else None
            state["tracing"] = None
        finally:
            if state["tracing"] is not None:
                state["tracing"].prof.stop()
        return {"requests": recs, "window_start": t0, "seconds": seconds,
                "result_wait_s": RESULT_WAIT_S,
                "trace": trace_rec, "config": ctx["conf"], "mix": ctx["mix"],
                "samples": samples,
                "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                      if self.dev.type == "cuda" else 0)}

    def close(self) -> None:
        from repro_torch.core.restore import shutdown_tail_pool
        ctx = self.ctx
        if ctx.get("router") is not None:
            ctx["router"].close()
        if ctx.get("orch") is not None:
            ctx["orch"].close()
        shutdown_tail_pool()
        ctx["router"] = ctx["orch"] = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        shutil.rmtree(self.store, ignore_errors=True)


def counts_of(recs: list) -> dict:
    return {"cold": sum(1 for r in recs if r.get("cold")),
            "warm": sum(1 for r in recs if r.get("cold") is False),
            "failed": sum(1 for r in recs if r["error"] is not None)}


def read_metrics(c: dict, rec: dict, kind: str, root=spec.ROOT) -> dict:
    metrics = {}
    for m in c[kind]:
        v = spec.reader(m["name"], root)(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    return metrics


def run_cell(c: dict, *, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, root=spec.ROOT) -> dict:
    """One run of cell ``c`` (``spec.cell``); returns the result line."""
    sut = System(c, seed=seed, device=device)
    try:
        rec = sut.window(seconds, trace)
        rec["setup_s"] = rec["window_start"] - t_start
        stats = counts_of(rec["requests"])
        errors = sorted({r["error"] for r in rec["requests"] if r["error"] is not None})
        emit({"phase": "window", "requests": len(rec["requests"]), **stats,
              "errors": errors[:3],
              "setup_stages": sut.ctx["stages"], "setup_s": rec["setup_s"],
              "page_cache_dropped": False,
              "page_cache_note": "not dropped: the benchmark changes no machine setting"})
    finally:
        sut.close()
    written = bytes_written()
    emit({"phase": "disk", "bytes_written": None if sut.w0 is None or written is None
          else written - sut.w0})
    metrics = read_metrics(c, rec, "per_layer" if trace else "end_to_end", root)

    t = time.perf_counter()
    check = compare(sut.ctx, rec["samples"])
    compared = {
        "logit_err": {"value": check["logit_err"], "limit": c["cell"]["limits"]["logit_err"]},
        "failed": {"value": stats["failed"], "limit": 0},
        "cold_invocations": {"value": stats["cold"], "limit": 0},
    }
    emit({"phase": "check", "sampled_invocations": len(rec["samples"]),
          "sampled_tokens": check["tokens"], "argmax_gap": check["argmax_gap"],
          "reference_s": time.perf_counter() - t})
    dev = sut.dev
    result = {"correct": all(v["value"] <= v["limit"] for v in compared.values()),
              "attempted": len(rec["requests"]), "failed": stats["failed"],
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                         "kind": torch.cuda.get_device_name(0) if dev.type == "cuda"
                         else "cpu",
                         "count": 1, "memory_peak_bytes": rec["memory_peak_bytes"]}}
    if rec["trace"] is not None:
        result["device"].update(busy_s=rec["trace"]["busy_s"],
                                window_s=rec["trace"]["window_s"])
        result["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                               "idle_gaps": rec["trace"]["idle_gaps"]}
    result["compared"] = compared
    return result


def main(args, t_start: float) -> int:
    """The command line's run: refuses without the cards the cell asks for."""
    bench = spec.load_benchmark()
    c = spec.cell(bench, args.workload)
    chips = c["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"cuda available: {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    emit({"phase": "environment", **card(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "workload": args.workload, "seed": args.seed,
          "seconds": args.seconds, "trace": args.trace})
    result = run_cell(c, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                      device="cuda", t_start=t_start)
    found = loaded_forbidden()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    for name, v in result["compared"].items():
        print(f"compared {name}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
