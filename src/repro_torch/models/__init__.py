"""Model-family registry.

A family module exposes:

- ``param_specs(cfg)``: the parameter spec tree;
- ``forward(cfg, params, batch, *, plain=False)``: logits (B, S, vocab);
- ``cache_specs(cfg, batch, max_len)``: the decode cache's spec tree;
- ``prefill(cfg, params, batch, cache, *, plain=False)``: fills the cache
  in place from a prompt, returns (last-position logits, cache);
- ``decode(cfg, params, cache, batch, pos, *, plain=False)``: one token at
  position ``pos``, returns (logits, cache).

``plain`` runs the kernels' plain versions instead of the kernels.  The
dense, hybrid (Mamba2/Zamba2) and RWKV6 families are ported; the others
raise and name the ROADMAP item (§A) that ports them.
"""
from __future__ import annotations

from ..configs.base import ModelConfig
from . import rwkv6, transformer, zamba

FAMILIES = {"dense": transformer, "hybrid": zamba, "rwkv": rwkv6}

_NOT_PORTED = {
    "moe": "A7 (MoE)",
    "vlm": "A8 (the VLM path)",
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
