"""Optimizers without external dependencies: AdamW and SGD-momentum.  The
JAX package's ``repro.training.optimizer``, in PyTorch.

The state mirrors the parameter tree leaf for leaf -- ``{"mu", "nu",
"count"}`` (AdamW) or ``{"mu", "count"}`` (SGD-momentum), float32 moments
and an int32 count -- so a checkpoint of it has the JAX package's arena
layout.  Every formula is the JAX package's, applied leaf by leaf in the
tree's sorted-key order (``jax.tree`` order): bias correction with the
float32 count, decoupled weight decay on leaves of ``ndim >= 2`` only, the
update computed in float32 and cast back to the parameter's dtype.
``torch.optim.AdamW`` is not used: it decays every leaf, and orders its
operations otherwise.  Updates return new tensors, as the JAX package
does, so one set of params can feed two steps.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..nn.spec import TensorSpec, map_leaves


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def state_specs(param_specs_tree, opt: OptConfig):
    """Spec tree of the optimizer state (drives the checkpoint's layout)."""
    def f32_like(_, s: TensorSpec) -> TensorSpec:
        return TensorSpec(s.shape, "float32", s.axes, "zeros", None)

    if opt.kind == "adamw":
        return {
            "mu": map_leaves(f32_like, param_specs_tree),
            "nu": map_leaves(f32_like, param_specs_tree),
            "count": TensorSpec((), "int32", (), "zeros"),
        }
    if opt.kind == "sgdm":
        return {
            "mu": map_leaves(f32_like, param_specs_tree),
            "count": TensorSpec((), "int32", (), "zeros"),
        }
    raise ValueError(opt.kind)


def tree_leaves(tree, prefix: str = ""):
    """(path, leaf) of a nested dict in sorted-key order, ``jax.tree``'s."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), tree


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, in sorted-key order; the result has ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def init_state(params, opt: OptConfig):
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    dev = next(tree_leaves(params))[1].device
    count = torch.zeros((), dtype=torch.int32, device=dev)
    if opt.kind == "adamw":
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
                "count": count}
    return {"mu": tree_map(zeros, params), "count": count}


def lr_at(opt: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor), float32: linear
    warmup, then a cosine down to ``min_lr_ratio``."""
    step = (step.to(torch.float32) if torch.is_tensor(step)
            else torch.tensor(step, dtype=torch.float32))
    warm = step / max(opt.warmup_steps, 1)
    prog = torch.clamp((step - opt.warmup_steps)
                       / max(opt.total_steps - opt.warmup_steps, 1), 0, 1)
    pi = torch.tensor(math.pi, dtype=torch.float32, device=step.device)
    cos = opt.min_lr_ratio + (1 - opt.min_lr_ratio) * 0.5 * (1 + torch.cos(pi * prog))
    return opt.lr * torch.where(step < opt.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    total = 0
    for _, g in tree_leaves(tree):
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), norm


def apply_updates(params, grads, state, opt: OptConfig):
    """One optimizer step.  Returns (new_params, new_state, metrics).

    The clipped float32 gradient of a leaf is formed just before its update
    (``clip_by_global_norm``'s values), so the float32 copies of the whole
    tree never coexist."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, opt.grad_clip)
    count = state["count"] + 1
    lr = lr_at(opt, count)
    cf = count.to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=cf.device)

    if opt.kind == "adamw":
        bc1 = 1 - (one * opt.b1) ** cf
        bc2 = 1 - (one * opt.b2) ** cf

        def upd(p, g, m, v):
            g = g.to(torch.float32) * scale
            m2 = opt.b1 * m + (1 - opt.b1) * g
            v2 = opt.b2 * v + (1 - opt.b2) * torch.square(g)
            step = (m2 / bc1) / (torch.sqrt(v2 / bc2) + opt.eps)
            if p.dim() >= 2:  # decoupled weight decay on matrices only
                step = step + opt.weight_decay * p.to(torch.float32)
            p2 = p.to(torch.float32) - lr * step
            return p2.to(p.dtype), m2, v2
        flat = tree_map(upd, params, grads, state["mu"], state["nu"])
        new_state = {"mu": _pick(flat, 1), "nu": _pick(flat, 2), "count": count}
    elif opt.kind == "sgdm":
        def upd(p, g, m):
            g = g.to(torch.float32) * scale
            m2 = 0.9 * m + g
            p2 = p.to(torch.float32) - lr * m2
            return p2.to(p.dtype), m2
        flat = tree_map(upd, params, grads, state["mu"])
        new_state = {"mu": _pick(flat, 1), "count": count}
    else:
        raise ValueError(opt.kind)
    return _pick(flat, 0), new_state, {"grad_norm": gnorm, "lr": lr}


def _pick(tree, i: int):
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
