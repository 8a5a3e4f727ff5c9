"""Scenario, on the PyTorch port: end-to-end fault-tolerant training.

Trains a reduced model for a few hundred steps, gets preempted halfway,
restarts from the async checkpoint with a REAP single-read restore, and
verifies the loss trajectory is identical to an uninterrupted run.

    PYTHONPATH=src python examples/torch_train_fault_tolerant.py [--steps 200]   # the card
    PYTHONPATH=src python examples/torch_train_fault_tolerant.py --device cpu

Exits non-zero unless the restarted run's last losses equal the
uninterrupted run's within ``RESTART_RTOL`` and the restore took no page
fault.
"""
import argparse
import os
import shutil
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import SMOKES  # noqa: E402
from repro_torch.data import synthesize_corpus  # noqa: E402
from repro_torch.training import (OptConfig, SimulatedPreemption, Trainer,  # noqa: E402
                                  TrainLoopConfig)

# The restarted run reads the checkpoint's bytes and the same batches as
# the uninterrupted one, through the same deterministic arithmetic: its
# losses should be equal; 1e-6 relative leaves room for a library
# reduction whose order varies from run to run.
RESTART_RTOL = 1e-6
TAIL = 5


def run(arch: str = "olmo-1b", steps: int = 200, workdir: str = ".ft_train",
        device: str = "cuda", log=print) -> dict:
    """Train ``arch``'s SMOKE config for ``steps`` steps, preempted at half
    and restarted from its last checkpoint, then uninterrupted in a second
    checkpoint directory.  Returns the three runs' losses (``preempted``,
    ``restarted``, ``uninterrupted``), the restart's ``restore_stats`` and
    the tails' largest relative difference."""
    cfg = SMOKES[arch]
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    corpus = synthesize_corpus(os.path.join(workdir, "corpus.bin"), 2_000_000,
                               cfg.vocab)
    loop = TrainLoopConfig(total_steps=steps, checkpoint_every=25, batch_size=8,
                           seq_len=64, restore_mode="reap")
    opt = OptConfig(lr=3e-3, warmup_steps=20, total_steps=steps)

    log(f"training {cfg.name} for {steps} steps, preempting at step {steps // 2}...")
    tr = Trainer(cfg, opt, loop, corpus, os.path.join(workdir, "ckpt"),
                 preempt_at=steps // 2, device=device)
    try:
        tr.run()
        raise RuntimeError("the run was not preempted")
    except SimulatedPreemption as e:
        log(f"  !! node lost: {e}")
    preempted = tr.losses

    log("restarting from checkpoint (REAP single-read restore)...")
    out = Trainer(cfg, opt, loop, corpus, os.path.join(workdir, "ckpt"),
                  device=device).run()
    rs = out["restore_stats"]
    log(f"  restored {rs['bytes']/1e6:.0f}MB in {rs['io_s']*1e3:.0f}ms "
        f"({rs['n_faults']} faults)")
    log(f"  finished at step {out['final_step']}; "
        f"loss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}")

    log("verifying against an uninterrupted run...")
    ref = Trainer(cfg, opt, loop, corpus, os.path.join(workdir, "ckpt_ref"),
                  device=device).run()
    tail = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(out["losses"][-TAIL:], ref["losses"][-TAIL:]))
    return {"function": cfg.name, "steps": steps, "preempted": preempted,
            "restarted": out["losses"], "uninterrupted": ref["losses"],
            "restore_stats": rs, "tail_rel_diff": tail}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--workdir", default=".ft_train")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.arch, args.steps, args.workdir, args.device)
    ok = out["tail_rel_diff"] <= RESTART_RTOL and out["restore_stats"]["n_faults"] == 0
    print(f"  max tail-loss divergence: {out['tail_rel_diff']:.2e} relative "
          f"({'OK' if ok else 'MISMATCH'})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
