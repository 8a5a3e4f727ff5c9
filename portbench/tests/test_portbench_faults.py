"""A whole run on the CPU at SMOKE sizes, the chip's look skipped: sound,
it comes out correct; with the timed path broken underneath, ``correct``
comes out false, once for each fault the cell can have (an answer altered
where it is produced; half of a batch left out, its answers copied from
the rest). A cell on one chip has no exchange between chips, and a scoring
cell no state that a step could leave unchanged.

The limit here is the smoke sizes' own (their logits are a tenth of full
width's): sound runs read about 0.007, so 0.05 leaves room on both sides.
The control's readings at the cells' own sizes are ``calibrate.py``'s, on
the card; ``test_control_fails_at_the_cells_size`` repeats them there."""
import importlib
import time

import pytest
import torch

from conftest import smoke_cell
from portbench import spec

SMOKE_LIMIT = 0.05


def _run(name, monkeypatch=None, fault=None, seconds=1.5):
    from portbench import harness
    c = smoke_cell(name)
    c["cell"] = dict(c["cell"], limits={"logit_err": SMOKE_LIMIT})
    if fault is not None:
        family = importlib.import_module("repro_torch.models.transformer")
        monkeypatch.setattr(family, "forward", fault(family.forward))
    return harness.run_cell(c, seed=2**31 + 3, seconds=seconds, trace=False,
                            device="cpu", t_start=time.perf_counter())


def altered(forward):
    def run(cfg, params, batch, **kw):
        out = forward(cfg, params, batch, **kw)
        return out + torch.where(torch.arange(out.shape[1]) == 0, 1.0, 0.0)[None, :, None]
    return run


def half_batch(forward):
    def run(cfg, params, batch, **kw):
        tokens = batch["tokens"]
        half = max(tokens.shape[0] // 2, 1)
        out = forward(cfg, params, dict(batch, tokens=tokens[:half]), **kw)
        return torch.cat([out] * (tokens.shape[0] // half), dim=0)[:tokens.shape[0]]
    return run


@pytest.mark.parametrize("name", ["olmo-1b.warm-score"])
def test_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"], res["compared"]
    assert list(res["compared"])[0] == "logit_err" and list(res)[-1] == "compared"
    assert res["failed"] == 0 and res["attempted"] > 0
    assert res["compared"]["cold_invocations"]["value"] == 0


@pytest.mark.parametrize("name,fault", [
    ("olmo-1b.warm-score", altered), ("olmo-1b.warm-score", half_batch)])
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    res = _run(name, monkeypatch, fault)
    assert not res["correct"], res["compared"]
    assert res["compared"]["logit_err"]["value"] > SMOKE_LIMIT


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in spec.load_benchmark()["workloads"]])
def test_control_fails_at_the_cells_size(name, cuda):
    """The reference in float8 e4m3 in the program's place, at the cell's
    own size, on three seeds: each reading is above the cell's limit."""
    from portbench import calibrate
    c = spec.cell(spec.load_benchmark(), name)
    limit = c["cell"]["limits"]["logit_err"]
    for seed in (11, 2**31 + 12, 13):
        assert calibrate.control_reading(c, seed, "cuda")["logit_err"] > limit
