"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [--smoke]``.

End to end: synthetic corpus -> fault-tolerant train loop (async
checkpoints through the snapshot substrate, REAP-accelerated restart).
The JAX package's CLI with its flags, plus ``--device`` (default
``cuda``; ``cpu`` trains on the CPU).  ``--smoke`` takes the reduced
same-family config.
"""
from __future__ import annotations

import argparse
import os


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--workdir", default=".train")
    ap.add_argument("--restore-mode", default="reap", choices=["reap", "lazy"])
    ap.add_argument("--preempt-at", type=int, default=None,
                    help="simulate preemption at this step (fault-tolerance demo)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..configs import ARCHS, SMOKES
    from ..data import synthesize_corpus
    from ..training import (OptConfig, SimulatedPreemption, Trainer,
                            TrainLoopConfig)

    cfg = SMOKES[args.arch] if args.smoke else ARCHS[args.arch]
    os.makedirs(args.workdir, exist_ok=True)
    corpus = synthesize_corpus(
        os.path.join(args.workdir, f"corpus_{cfg.vocab}.bin"),
        max(args.steps * args.batch * args.seq * 2, 200_000), cfg.vocab)

    loop = TrainLoopConfig(
        total_steps=args.steps, checkpoint_every=args.checkpoint_every,
        batch_size=args.batch, seq_len=args.seq,
        restore_mode=args.restore_mode)
    tr = Trainer(cfg, OptConfig(lr=1e-3, warmup_steps=5,
                                total_steps=args.steps),
                 loop, corpus, os.path.join(args.workdir, "ckpt"),
                 preempt_at=args.preempt_at, device=args.device)
    try:
        out = tr.run()
    except SimulatedPreemption as e:
        print(f"!! {e} -- restart with the same command to resume")
        return
    print(f"arch={cfg.name} steps={out['final_step']} "
          f"loss[0]={out['losses'][0]:.4f} loss[-1]={out['losses'][-1]:.4f} "
          f"({out['seconds']:.1f}s)")
    if out["restore_stats"]:
        rs = out["restore_stats"]
        print(f"restored via {args.restore_mode}: {rs['bytes']/1e6:.1f}MB "
              f"in {rs['io_s']*1e3:.1f}ms ({rs['n_faults']} faults)")


if __name__ == "__main__":
    main()
