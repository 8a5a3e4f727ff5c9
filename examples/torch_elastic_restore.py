"""Scenario: elastic re-shard restore, on the PyTorch port.

A checkpoint written by one training topology is restored onto a DIFFERENT
mesh by reading exactly the per-shard byte ranges each host owns -- the
arena layout is mesh-agnostic, so scaling from N to M hosts is a restore,
not a re-write.

    PYTHONPATH=src python examples/torch_elastic_restore.py            # the card
    PYTHONPATH=src python examples/torch_elastic_restore.py --device cpu

Exits non-zero when a restore is not bit-identical to the saved tensors.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.configs import SMOKES  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.training import optimizer as opt_lib  # noqa: E402
from repro_torch.training.checkpoint import (restore_for_mesh,  # noqa: E402
                                             save_checkpoint)
from repro_torch.training.optimizer import tree_leaves  # noqa: E402


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8) if t.dim() else t.reshape(1).view(torch.uint8)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dir", default=".elastic")
    args = ap.parse_args(argv)
    cfg = SMOKES["qwen2-7b"]
    params = steps.init_params(cfg, 0, args.device)
    state = opt_lib.init_state(params, opt_lib.OptConfig())
    os.makedirs(args.dir, exist_ok=True)
    base = save_checkpoint(os.path.join(args.dir, "ckpt"), params, state, 42)
    print(f"checkpoint written by the 'old' topology: {base}.mem")

    failed = 0
    for n_hosts in (2, 4, 8):
        mesh = Mesh({"data": n_hosts})
        restored = restore_for_mesh(base, steps.param_specs(cfg), mesh, {},
                                    device=args.device)
        got = dict(tree_leaves(restored))
        ok = all(got[p].dtype == t.dtype and torch.equal(bits(got[p]), bits(t))
                 for p, t in tree_leaves(params))
        failed += not ok
        print(f"  restore onto {n_hosts:2d}-host mesh: "
              f"{'bit-identical' if ok else 'MISMATCH'}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
