"""Shared set-up of the benchmark's own tests: the checkout's root and the
port's sources on the path, and the cells at the port's SMOKE sizes, small
enough for a CPU run."""
import dataclasses
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

#: the mix cut to CPU sizes (the kind, the callers and the instances are
#: the cell's own)
SMALL_MIX = {"lengths": [16, 32], "weights": [0.5, 0.5], "batch": 2, "sample_span": 10}


def smoke_cell(name: str, **mix) -> dict:
    """Cell ``name`` (``<config>.<traffic>``, with its file under
    ``cells/``, whether or not BENCHMARK.json runs it) with its
    configuration at the port's SMOKE sizes."""
    from portbench import spec
    from repro_torch.configs import SMOKES
    config, traffic = name.rsplit(".", 1)
    bench = spec.load_benchmark()
    c = dict(spec.pieces(name, spec.HERE / "configs" / f"{config}.json", traffic),
             end_to_end=spec.metrics_of(bench, name, "end_to_end"),
             per_layer=spec.metrics_of(bench, name, "per_layer"))
    conf = c["config"]
    cfg = SMOKES[conf["port_config"]]
    small = dict(dataclasses.asdict(cfg), head_dim=cfg.resolved_head_dim)
    small.pop("name")
    c["config"] = dict(conf, **{k: v for k, v in small.items() if k in conf},
                       preset="smoke")
    c["mix"] = dict(c["mix"], **{k: v for k, v in dict(SMALL_MIX, **mix).items()
                                 if k in c["mix"]})
    return c


@pytest.fixture
def cuda():
    """Skips a test that needs a CUDA device where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
