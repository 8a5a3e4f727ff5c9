"""Step functions and inputs for the port's model families.

The JAX package's ``repro.launch.steps`` without the train step (training
is not ported yet) and without the abstract ``input_specs`` of its dry
run.  Inputs come from a numpy generator (the JAX package draws them from
``jax.random``, which the port cannot reproduce): they stay host arrays
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
    """(shape, dtype name) per input tensor for one step of ``kind``: the
    VLM's prompt is ``n_patches`` patch embeddings and ``seq - n_patches``
    tokens, the encoder-decoder's carries ``seq // frame_stride`` frame
    embeddings; a decode step takes one token."""
    if kind == "decode":
        return {"tokens": ((batch, 1), "int32")}
    if cfg.family == "vlm":
        n_txt = max(seq - cfg.n_patches, 1)
        return {"tokens": ((batch, n_txt), "int32"),
                "patch_embeds": ((batch, cfg.n_patches, cfg.d_model), "bfloat16")}
    if cfg.family == "encdec":
        return {"tokens": ((batch, seq), "int32"),
                "frames": ((batch, max(seq // cfg.frame_stride, 1), cfg.d_model),
                           "bfloat16")}
    return {"tokens": ((batch, seq), "int32")}


def make_batch(cfg: ModelConfig, seq: int, batch: int, kind: str,
               rng: np.random.Generator | int = 0) -> dict:
    """Inputs for one step from ``rng`` (a numpy generator or a seed), in
    ``batch_shapes`` order: int32 tokens uniform over the vocabulary, and
    float inputs as ``standard_normal`` float32 times 0.02, which round to
    bfloat16 where the model casts them (so the same arrays can feed both
    packages)."""
    rng = np.random.default_rng(rng)
    out = {}
    for name, (shape, dtype) in batch_shapes(cfg, seq, batch, kind).items():
        if dtype == "int32":
            out[name] = rng.integers(0, cfg.vocab, shape, dtype=np.int32)
        else:
            out[name] = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
    return out


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
    (``host_initialize``, bit for bit), on ``device``: drawn and copied a
    slice at a time (``nn.spec.stream_initialize``), so the host never
    holds a whole leaf."""
    return nnspec.stream_initialize(param_specs(cfg), seed, device_of(device))


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Any = "cuda") -> dict:
    """A zeroed decode cache for ``batch`` sequences of up to ``max_len``
    tokens, on ``device``."""
    dev = device_of(device)
    return nnspec.map_leaves(
        lambda _, s: torch.zeros(s.shape, dtype=nnspec.torch_dtype(s.dtype),
                                 device=dev),
        cache_specs(cfg, batch, max_len))
