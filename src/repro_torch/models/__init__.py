"""Model-family registry.

A family module exposes ``param_specs(cfg)`` (the spec tree) and
``forward(cfg, params, batch, *, attn=None)`` (logits).  This slice ports
the dense family only; the others raise and name the ROADMAP item (§A)
that ports them.
"""
from __future__ import annotations

from ..configs.base import ModelConfig
from . import transformer

FAMILIES = {"dense": transformer}

_NOT_PORTED = {
    "moe": "A7 (MoE)",
    "vlm": "A8 (the VLM path)",
    "hybrid": "A8 (Mamba2/Zamba)",
    "rwkv": "A8 (RWKV6)",
    "encdec": "A8 (encoder-decoder)",
}


def get_family(cfg: ModelConfig):
    fam = FAMILIES.get(cfg.family)
    if fam is None:
        item = _NOT_PORTED.get(cfg.family, "none")
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.name}) is not ported to "
            f"repro_torch yet; ROADMAP item {item} ports it")
    return fam
