"""The plain reference agrees with the port's forward at the SMOKE sizes
(both in float32 on the same weights), and its control is coarser."""
import importlib

import numpy as np
import pytest
import torch

from conftest import smoke_cell


def _port_params(cfg, flat):
    from repro_torch.models import get_family
    from repro_torch.nn import spec as nnspec
    return nnspec.map_leaves(lambda p, s: flat[p], get_family(cfg).param_specs(cfg))


@pytest.mark.parametrize("name", ["olmo-1b.warm-score"])
def test_reference_matches_the_port_in_float32(name):
    from portbench import harness, weights
    from repro_torch.models import get_family
    c = smoke_cell(name)
    cfg = harness.port_config(c["config"])
    flat = weights.params_f32(cfg, 2**31 + 11, "cpu")
    ref = importlib.import_module(f"portbench.reference.{c['config']['reference']}")
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (2, 40), dtype=np.int32)
    with torch.no_grad():
        got = get_family(cfg).forward(cfg, _port_params(cfg, flat), {"tokens": tokens})
        for b in range(2):
            want = ref.forward(c["config"], flat, torch.as_tensor(tokens[b]).long())
            assert want.shape == (40, cfg.vocab)
            scale = float(want.abs().max())
            assert float((got[b] - want).abs().max()) <= 2e-5 * max(scale, 1.0)


def test_control_precision_is_coarser():
    """The control (matrix products' operands in float8 e4m3) departs from
    float32 by far more than float32 does from itself."""
    from portbench import harness, weights
    c = smoke_cell("olmo-1b.warm-score")
    cfg = harness.port_config(c["config"])
    flat = weights.params_f32(cfg, 9, "cpu")
    ref = importlib.import_module("portbench.reference.dense")
    tok = torch.as_tensor(np.arange(32) % cfg.vocab).long()
    with torch.no_grad():
        f32 = ref.forward(c["config"], flat, tok)
        fp8 = ref.forward(c["config"], flat, tok, precision="fp8")
    assert float((fp8 - f32).abs().max()) > 1e-2
