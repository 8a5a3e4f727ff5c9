"""Step functions and inputs for the port's model families.

The JAX package's ``repro.launch.steps`` without the abstract
``input_specs`` of its dry run.  Inputs come from a numpy generator (the
JAX package draws them from ``jax.random``, which the port cannot
reproduce): they stay host arrays that the models move to their device.  ``init_params`` writes the same
bytes as a snapshot (``nn.spec.host_initialize``) and ``init_cache`` makes
zeros; both go to the card unless the caller asks for the CPU.  The train
step (:func:`build_train_step`) runs on its params' device: the family's
``loss``, its gradient over every param leaf by ``torch.autograd.grad``,
then ``training.optimizer.apply_updates``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import device_of
from ..models import get_family
from ..nn import spec as nnspec
from ..training import optimizer as opt_lib
from ..training.optimizer import tree_leaves


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


def _unflatten(paths: list[str], leaves: list) -> dict:
    tree: dict = {}
    for path, leaf in zip(paths, leaves):
        *parents, name = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree


def loss_and_grads(cfg: ModelConfig, params: dict, batch: dict, *,
                   remat: bool = False, remat_policy=None, plain: bool = False):
    """(loss, grads): the family's loss on ``batch`` and its gradient with
    respect to every param leaf, a tree of the params' structure with each
    gradient in its param's dtype (zeros for a leaf the loss does not
    read), as ``jax.value_and_grad`` gives them.  ``params`` is left as it
    is: the leaves differentiated are detached views of it."""
    fam = get_family(cfg)
    paths, leaves = [], []
    for path, t in tree_leaves(params):
        paths.append(path)
        leaves.append(t.detach().requires_grad_(True))
    with torch.enable_grad():
        loss = fam.loss(cfg, _unflatten(paths, leaves), batch, remat=remat,
                        remat_policy=remat_policy, plain=plain)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, leaves)]
    return loss.detach(), _unflatten(paths, grads)


def build_train_step(cfg: ModelConfig, opt: opt_lib.OptConfig, *,
                     remat: bool = True, remat_policy=None,
                     grad_dtype: torch.dtype = torch.float32, microbatches: int = 1,
                     accum_dtype: torch.dtype = torch.float32, plain: bool = False,
                     grad_shardings=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with ``loss``, ``grad_norm`` and ``lr`` in ``metrics``; the
    params and state returned are new tensors.

    ``microbatches > 1`` takes the batch in that many slices along its
    first axis and accumulates their gradients in ``accum_dtype``, then
    divides loss and gradients by the count (gradients to float32), as the
    JAX package's ``scan`` does.  ``grad_dtype`` other than float32 casts
    the gradients before the update.  ``plain`` runs the kernels' plain
    versions.  ``grad_shardings`` (a params-shaped tree of
    ``nn.spec.Sharding``, as the JAX package takes it to pin the
    accumulator to the parameters' layout) is accepted and does nothing:
    one process holds every gradient whole."""
    def grads_of(params, batch):
        return loss_and_grads(cfg, params, batch, remat=remat,
                              remat_policy=remat_policy, plain=plain)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = grads_of(params, batch)
        else:
            n = next(iter(batch.values())).shape[0]
            if n % microbatches:
                raise ValueError(f"batch of {n} does not split into {microbatches} "
                                 "microbatches")
            mb = n // microbatches
            loss, acc = 0.0, None
            for i in range(microbatches):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l, g = grads_of(params, part)
                g = opt_lib.tree_map(lambda t: t.to(accum_dtype), g)
                acc = g if acc is None else opt_lib.tree_map(torch.add, acc, g)
                loss = loss + l
            loss = loss / microbatches
            grads = opt_lib.tree_map(lambda t: (t / microbatches).to(torch.float32), acc)
        if grad_dtype != torch.float32:
            grads = opt_lib.tree_map(lambda t: t.to(grad_dtype), grads)
        new_params, new_state, metrics = opt_lib.apply_updates(params, grads,
                                                               opt_state, opt)
        metrics["loss"] = loss
        return new_params, new_state, metrics

    return train_step


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
