"""Quickstart, on the PyTorch port: deploy a serverless ML function, watch
REAP slash its cold start, all through the public API.

    PYTHONPATH=src python examples/torch_quickstart.py [--arch qwen2-7b]   # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Exits non-zero unless the REAP cold start's logits equal the record
request's bit for bit and the warm request took no page fault.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import ARCHS, SMOKES  # noqa: E402
from repro_torch.core import ReapConfig  # noqa: E402
from repro_torch.core.pagestore import read_manifest  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.serving import Orchestrator, ServeConfig  # noqa: E402


def report(rep) -> dict:
    """Faults, prefetched pages and the stage seconds of one request."""
    return {"n_faults": rep.n_faults, "n_prefetched_pages": rep.n_prefetched_pages,
            "load_vmm_s": rep.load_vmm_s, "connection_s": rep.connection_s,
            "prefetch_s": rep.prefetch_s, "install_s": rep.install_s,
            "processing_s": rep.processing_s}


def run(arch: str = "qwen2-7b", store: str = ".quickstart_store",
        device: str = "cuda") -> dict:
    """Register ``arch``'s SMOKE config, then serve one request three
    times: cold (REAP record), warm, and cold again after scale-to-zero
    (REAP prefetch).  Returns the request, each invocation's ``report``,
    the working set's pages and the record's and the REAP cold start's
    logits."""
    cfg = SMOKES[arch]
    request = steps.make_batch(cfg, 64, 1, "train", 0)
    orch = Orchestrator(store, ServeConfig(mode="reap", reap=ReapConfig(),
                                           device=device))
    try:
        orch.register(arch, cfg, warmup_batch=request)
        record, r_record = orch.invoke(arch, request, force_cold=True)
        _, r_warm = orch.invoke(arch, request)
        orch.scale_to_zero(arch)
        cold, r_cold = orch.invoke(arch, request, force_cold=True)
        ws = read_manifest(orch.functions[arch].base + ".ws")
    finally:
        orch.close()
    return {"function": cfg.name, "request": request, "record": report(r_record),
            "warm": report(r_warm), "reap_cold": report(r_cold), "ws_pages": len(ws["pages"]),
            "record_logits": record, "reap_cold_logits": cold}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-7b", choices=list(ARCHS))
    ap.add_argument("--store", default=".quickstart_store")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    print(f"deploying {SMOKES[args.arch].name} (builds the snapshot on first "
          "deploy)...")
    out = run(args.arch, args.store, args.device)
    r = out["record"]
    print("\n1) first cold invocation (REAP record phase):")
    print(f"   load_vmm={r['load_vmm_s']*1e3:.1f}ms conn={r['connection_s']*1e3:.2f}ms "
          f"processing={r['processing_s']*1e3:.1f}ms  page_faults={r['n_faults']}")
    r = out["warm"]
    print("2) warm invocation (instance stayed resident):")
    print(f"   processing={r['processing_s']*1e3:.1f}ms  page_faults={r['n_faults']}")
    r = out["reap_cold"]
    print("3) cold again -- but now REAP prefetches the working set:")
    print(f"   prefetch={r['prefetch_s']*1e3:.1f}ms ({r['n_prefetched_pages']} pages, "
          f"one O_DIRECT read) processing={r['processing_s']*1e3:.1f}ms "
          f"page_faults={r['n_faults']}")
    same = torch.equal(out["record_logits"], out["reap_cold_logits"])
    print(f"REAP cold logits {'==' if same else '!='} record logits (bitwise); "
          f"warm page faults {out['warm']['n_faults']}")
    return 0 if same and out["warm"]["n_faults"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
