"""Step analysis: FLOPs, bytes written, live memory and collective traffic
of one step.  The counterpart of the JAX package's ``hlo_analysis``, which
parses compiled XLA text; the port has none, so it counts a step traced
on fake tensors (``torch._subclasses.fake_tensor.FakeTensorMode``, nothing
allocated) under a ``TorchDispatchMode``:

  * ``dot`` FLOPs = 2 x |result| x the contracting size, for ``mm``,
    ``addmm``, ``bmm`` and ``baddbmm`` (einsum and linear lower to them):
    ``analyze_hlo``'s rule;
  * eager written bytes = bytes written by every aten op that makes or
    writes a buffer (views write nothing).  This is not ``analyze_hlo``'s
    HBM proxy, which counts the buffers left after XLA's fusion: every
    unfused op is counted here, and the plain versions traced in place of
    the kernels write what the kernels keep on chip (attention's scores),
    so it runs far above the card's traffic and feeds no roofline term;
  * the peak of the bytes of live buffers made during the step (buffers
    that exist before it, such as params and caches, are not counted),
    freed as their storage dies.

The roofline's memory term is a floor instead (:class:`Roofline`).  The
traced step is the global one: divide by the device count (FLOPs) or
the batch's data shards (activations) for a device's share.  The port has
no SPMD partitioner, so the FSDP collectives come from the partition
specs (:func:`fsdp_collectives`); tensor-parallel activation collectives
are not modelled.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..nn import spec as nnspec

_aten = torch.ops.aten


def _mm_flops(a, b) -> float:
    return 2.0 * a.shape[0] * b.shape[1] * a.shape[1]


def _bmm_flops(a, b) -> float:
    return 2.0 * a.shape[0] * a.shape[1] * b.shape[2] * a.shape[2]


_DOTS = {
    _aten.mm.default: lambda args: _mm_flops(args[0], args[1]),
    _aten.addmm.default: lambda args: _mm_flops(args[1], args[2]),
    _aten.bmm.default: lambda args: _bmm_flops(args[0], args[1]),
    _aten.baddbmm.default: lambda args: _bmm_flops(args[1], args[2]),
}


class StepCounter(TorchDispatchMode):
    """Counts the ops dispatched inside it: ``dot_flops``, eager
    ``written`` bytes, and the ``live`` and ``peak`` bytes of the buffers made."""

    def __init__(self):
        super().__init__()
        self.dot_flops = 0.0
        self.written = 0.0
        self.live = 0
        self.peak = 0
        self.n_ops = 0
        self._tracked: set[int] = set()

    def _freed(self, key: int, nbytes: int) -> None:
        self.live -= nbytes
        self._tracked.discard(key)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._tracked:
            return
        self._tracked.add(key)
        nbytes = st.nbytes()
        self.live += nbytes
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._freed, key, nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.n_ops += 1
        flops = _DOTS.get(func)
        if flops is not None:
            self.dot_flops += flops(args)
        outs = tree_flatten(out)[0]
        returns = func._schema.returns
        for i, t in enumerate(outs):
            if not isinstance(t, torch.Tensor):
                continue
            alias = returns[i].alias_info if i < len(returns) else None
            if alias is not None and not alias.is_write:
                continue                      # a view: nothing written
            self.written += t.numel() * t.element_size()
            if alias is None:                 # a new buffer
                self._track(t)
        return out

    def result(self) -> dict:
        return {"dot_flops": self.dot_flops,
                "eager_written_bytes": self.written,
                "peak_live_bytes": self.peak, "n_ops": self.n_ops}


def fake_tree(spec_tree, mode, *, requires_grad: bool = False):
    """A fake tensor per leaf of ``spec_tree``, made in FakeTensorMode
    ``mode`` (floating leaves require grad when ``requires_grad``)."""
    def one(_, s: nnspec.TensorSpec):
        with mode:
            t = torch.empty(s.shape, dtype=nnspec.torch_dtype(s.dtype))
        if requires_grad and t.is_floating_point():
            t.requires_grad_(True)
        return t
    return nnspec.map_leaves(one, spec_tree)


def fsdp_collectives(param_specs, rules, mesh, *, kind: str,
                     microbatches: int = 1, remat: bool = False) -> dict:
    """Per-device collective operand bytes and counts of one step, by
    ``analyze_hlo``'s definition, from the parameters' partition specs:
    each weight sharded on a data axis is all-gathered before its use in
    each microbatch's forward (operand: the device's shard), again in the
    backward when ``remat``, and (``kind == "train"``) its gradient is
    reduce-scattered (operand: the gradient before the data axes split it,
    in the parameter's dtype)."""
    from .sharding import data_axes
    d_axes = set(data_axes(mesh))
    gather = scatter = 0.0
    n_gather = n_scatter = 0
    for _, s in nnspec.tree_paths(param_specs):
        spec = nnspec._partition_spec(s, rules, mesh)
        axes = [a for e in spec for a in nnspec._entry_axes(e)]
        n_data = 1
        for a in axes:
            if a in d_axes:
                n_data *= mesh.shape[a]
        if n_data == 1:
            continue
        shard = nnspec.shard_bytes(s, spec, mesh)
        passes = 2 if (kind == "train" and remat) else 1
        gather += shard * passes * microbatches
        n_gather += passes * microbatches
        if kind == "train":
            scatter += shard * n_data * microbatches
            n_scatter += microbatches
    return {"bytes": {"all-gather": gather, "reduce-scatter": scatter},
            "count": {"all-gather": n_gather, "reduce-scatter": n_scatter}}


# --- NVIDIA H100 SXM data sheet, at its 700 W power limit -------------------
PEAK_FLOPS = 989e12       # bf16 dense tensor-core FLOP/s per card
HBM_BW = 3.35e12          # HBM3 bytes/s per card
NVLINK_BW = 450e9         # NVLink 4 bytes/s per direction per card


@dataclasses.dataclass
class Roofline:
    """Three-term roofline for one step.

    flops / min_hbm_bytes / coll_bytes are PER DEVICE, so the terms are
    per-card seconds directly.  ``min_hbm_bytes`` is a floor: the bytes of
    the step's state (parameters, gradients, cache, inputs) that a device
    must read or write once; activations are left out."""
    flops: float
    min_hbm_bytes: float
    coll_bytes: float
    n_chips: int
    model_flops: float = 0.0   # global (all chips)

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.min_hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        per_dev_model = self.model_flops / self.n_chips
        return per_dev_model / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """model-FLOPs utilization implied by the dominant term (an MFU
        upper bound: ideal_time(model_flops) / roofline_step_time)."""
        if not self.model_flops or not self.step_s:
            return 0.0
        ideal = self.model_flops / (self.n_chips * PEAK_FLOPS)
        return ideal / self.step_s

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "min_hbm_bytes_per_device": self.min_hbm_bytes,
            "coll_bytes_per_device": self.coll_bytes,
            "n_chips": self.n_chips, "model_flops": self.model_flops,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck, "step_s": self.step_s,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(cfg, shape, n_params_total: int, n_params_active: int) -> float:
    """6·N·D (train) / 2·N·D (inference) with MoE active-param counting."""
    n = n_params_active or n_params_total
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch
