"""Model-family registry.

A family module exposes:

- ``param_specs(cfg)``: the parameter spec tree;
- ``forward(cfg, params, batch, *, plain=False)``: logits (B, S, vocab);
- ``cache_specs(cfg, batch, max_len)``: the decode cache's spec tree;
- ``prefill(cfg, params, batch, cache, *, plain=False)``: fills the cache
  in place from a prompt, returns (last-position logits, cache);
- ``decode(cfg, params, cache, batch, pos, *, plain=False)``: one token at
  position ``pos``, returns (logits, cache);
- ``loss(cfg, params, batch, *, remat=False, remat_policy=None,
  plain=False)``: the mean next-token cross-entropy, float32.

``plain`` runs the kernels' plain versions instead of the kernels.  The
registry is the JAX package's: all six families (ten configs) are ported.
"""
from __future__ import annotations

from ..configs.base import ModelConfig
from . import encdec, moe, rwkv6, transformer, zamba

FAMILIES = {
    "dense": transformer,
    "vlm": transformer,
    "moe": moe,
    "hybrid": zamba,
    "rwkv": rwkv6,
    "encdec": encdec,
}


def get_family(cfg: ModelConfig):
    return FAMILIES[cfg.family]
