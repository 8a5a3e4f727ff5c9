"""Logical-axis -> mesh-axis sharding rules (MaxText-style).  The JAX
package's ``repro.distributed.sharding``, over ``launch.mesh.Mesh``.

Parameters carry logical axis names in their TensorSpec; these rules decide
the physical layout:

  * TP axes   ("heads", "kv_heads", "mlp", "vocab", "expert", "seq")
              -> "model"
  * FSDP axis ("embed" on weight matrices) -> ("pod", "data"): every
              weight is also sharded across the data-parallel axes
              (ZeRO-3 semantics).
  * batch     -> ("pod", "data") when divisible, else replicated (the
              long_500k batch=1 cell).

The dry run (``launch.dryrun``) and the elastic restore
(``training.checkpoint.restore_for_mesh``) read them; one process places
no tensor by them.
"""
from __future__ import annotations

import math
from typing import Any

from ..nn.spec import PartitionSpec, Sharding


def data_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def data_size(mesh) -> int:
    return math.prod(mesh.shape[a] for a in data_axes(mesh))


def batch_axes(mesh, batch: int) -> tuple[str, ...] | None:
    """Largest prefix of (pod, data) whose size divides ``batch``."""
    axes = data_axes(mesh)
    while axes:
        if batch % math.prod(mesh.shape[a] for a in axes) == 0:
            return axes
        axes = axes[1:]
    return None


def make_rules(mesh, *, batch: int | None = None,
               fsdp: bool = True, tp: bool = True) -> dict[str, Any]:
    model = "model" if (tp and "model" in mesh.axis_names) else None
    b_axes = batch_axes(mesh, batch) if batch is not None else data_axes(mesh)
    return {
        "heads": model,
        "kv_heads": model,
        "mlp": model,
        "vocab": model,
        "expert": model,
        "seq": model,       # KV-cache sequence sharding (decode/prefill)
        "state": None,
        "head_dim": None,
        "layers": None,
        "embed": data_axes(mesh) if fsdp else None,
        "batch": b_axes,
    }


# --- activation sharding constraints ---------------------------------------
#
# The JAX package pins activations for XLA's SPMD partitioner.  The port
# runs one process and has no partitioner, so installing rules stores
# nothing and every constraint returns its input unchanged.


def set_activation_rules(mesh, batch: int | None = None) -> None:
    """The JAX package's signature; one process has nothing to pin."""


def act_batch(x):
    """(B, S, d) etc.: dim 0 on the data axes.  One process: ``x``."""
    return x


def act_logits(x):
    """(B, S, V): batch on the data axes, vocab on model.  One process:
    ``x``."""
    return x


def act_heads(x):
    """(B, S, H, D): heads on model.  One process: ``x``."""
    return x


def act_expert(x):
    """(E, C, d): experts on model.  One process: ``x``."""
    return x


def batch_pspec(mesh, batch: int, ndim: int = 2) -> PartitionSpec:
    axes = batch_axes(mesh, batch)
    lead = axes if axes and len(axes) > 1 else (axes[0] if axes else None)
    return PartitionSpec(lead, *([None] * (ndim - 1)))


def batch_sharding(mesh, batch: int, ndim: int = 2) -> Sharding:
    return Sharding(mesh, batch_pspec(mesh, batch, ndim))


def replicated(mesh) -> Sharding:
    return Sharding(mesh, PartitionSpec())
