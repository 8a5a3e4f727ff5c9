"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Boots the orchestrator, registers the function (building its snapshot if
needed), then drives cold / REAP-cold / warm invocations and prints the
paper-style latency breakdown.  The JAX package's CLI with its flags, plus
``--device`` (default ``cuda``; ``cpu`` serves on the CPU).  As in the JAX
package, the function served is always the architecture's SMOKE config
(``--smoke`` is on by default and cannot be turned off).
"""
from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--store", default=".serve_store")
    ap.add_argument("--mode", default="reap", choices=["reap", "vanilla"])
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..configs import SMOKES
    from ..core import ReapConfig
    from ..launch import steps as steps_lib
    from ..serving import Orchestrator, ServeConfig

    cfg = SMOKES[args.arch]
    orch = Orchestrator(args.store, ServeConfig(mode=args.mode, reap=ReapConfig(),
                                                device=args.device))
    try:
        batch = steps_lib.make_batch(cfg, args.seq, args.batch, "train", 0)
        orch.register(args.arch, cfg, warmup_batch=batch)

        for i in range(args.requests):
            force_cold = i == 0
            if i == 1:
                orch.scale_to_zero(args.arch)  # second request is a REAP cold start
            _, r = orch.invoke(args.arch, batch, force_cold=force_cold)
            kind = ("cold" if r.n_faults or r.n_prefetched_pages else "warm")
            print(f"req{i} [{kind:4s}] load_vmm={r.load_vmm_s*1e3:6.1f}ms "
                  f"conn={r.connection_s*1e3:5.2f}ms "
                  f"prefetch={r.prefetch_s*1e3:6.1f}ms "
                  f"processing={r.processing_s*1e3:7.1f}ms "
                  f"faults={r.n_faults}")
    finally:
        orch.close()


if __name__ == "__main__":
    main()
