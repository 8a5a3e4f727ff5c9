"""Step functions and inputs for the port's model families.

The JAX package's ``repro.launch.steps`` without the train step (training
is not ported yet) and without the abstract ``input_specs`` of its dry
run.  Inputs come from a numpy generator (the JAX package draws them from
``jax.random``, which the port cannot reproduce): tokens stay a host array
that the models move to their device.  ``init_params`` writes the same
bytes as a snapshot (``nn.spec.host_initialize``) and ``init_cache`` makes
zeros; both go to the card unless the caller asks for the CPU.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import device_of
from ..models import get_family
from ..nn import spec as nnspec


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def batch_shapes(cfg: ModelConfig, seq: int, batch: int,
                 kind: str) -> dict[str, tuple[tuple[int, ...], str]]:
    """(shape, dtype name) per input tensor for one step of ``kind``.  The
    ported families take tokens only; the VLM and encoder-decoder inputs
    come with those families (ROADMAP A8)."""
    if cfg.family in ("vlm", "encdec"):
        raise NotImplementedError(f"{cfg.family} inputs are not ported yet (ROADMAP A8)")
    return {"tokens": ((batch, 1 if kind == "decode" else seq), "int32")}


def make_batch(cfg: ModelConfig, seq: int, batch: int, kind: str,
               rng: np.random.Generator | int = 0) -> dict:
    """Inputs for one step: int32 token arrays uniform over the vocabulary,
    from ``rng`` (a numpy generator or a seed)."""
    rng = np.random.default_rng(rng)
    return {name: rng.integers(0, cfg.vocab, shape, dtype=np.int32)
            for name, (shape, _) in batch_shapes(cfg, seq, batch, kind).items()}


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


def build_forward(cfg: ModelConfig):
    fam = get_family(cfg)

    def fwd(params, batch, **kw):
        return fam.forward(cfg, params, batch, **kw)

    return fwd


def build_prefill_step(cfg: ModelConfig):
    fam = get_family(cfg)

    def prefill_step(params, batch, cache, **kw):
        return fam.prefill(cfg, params, batch, cache, **kw)

    return prefill_step


def build_decode_step(cfg: ModelConfig):
    fam = get_family(cfg)

    def decode_step(params, cache, batch, pos, **kw):
        return fam.decode(cfg, params, cache, batch, pos, **kw)

    return decode_step


def param_specs(cfg: ModelConfig):
    return get_family(cfg).param_specs(cfg)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    return get_family(cfg).cache_specs(cfg, batch, max_len)


def init_params(cfg: ModelConfig, seed: int = 0, device: Any = "cuda") -> dict:
    """The parameters a snapshot of ``cfg`` built with ``seed`` holds
    (``host_initialize``, bit for bit), on ``device``."""
    dev = device_of(device)
    specs = param_specs(cfg)
    host = nnspec.host_initialize(specs, seed=seed)
    return nnspec.map_leaves(
        lambda p, s: nnspec.to_torch(host.pop(p), s.dtype).to(dev), specs)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Any = "cuda") -> dict:
    """A zeroed decode cache for ``batch`` sequences of up to ``max_len``
    tokens, on ``device``."""
    dev = device_of(device)
    return nnspec.map_leaves(
        lambda _, s: torch.zeros(s.shape, dtype=nnspec.torch_dtype(s.dtype),
                                 device=dev),
        cache_specs(cfg, batch, max_len))
