"""Dry run: trace every (arch x shape x mesh) cell on fake tensors and
write its memory, FLOPs, collectives and roofline.

    python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k \\
        --mesh single --out results/dryrun_torch

The JAX package's ``launch.dryrun`` lowers and compiles each cell for a
TPU mesh; the port has no SPMD compiler, so each cell's step runs once on
the host under ``FakeTensorMode`` (nothing is allocated, and on fake CPU
tensors the kernels' plain versions run) and ``distributed.step_analysis``
counts it.  Parameters, optimizer state, gradients and caches per device
come from the partition specs over the JAX package's logical meshes
(``launch.mesh``); activations are the traced step's peak over the
batch's data shards.  The roofline's memory term is the floor of the
state a device reads or writes once, not the traced ops' written bytes
(``step_analysis``).  The roofline takes the NVIDIA H100 SXM's data sheet
(``step_analysis``), and ``fits_hbm`` its 80 GB.  One JSON per cell.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..configs import ARCHS, SHAPES, shape_applicable
from ..configs.base import ModelConfig, ShapeConfig
from ..distributed import sharding as shd
from ..distributed.step_analysis import (Roofline, StepCounter, fake_tree,
                                         fsdp_collectives, model_flops)
from ..models import get_family
from ..nn import spec as nnspec
from ..training import optimizer as opt_lib
from . import steps as steps_lib
from .mesh import make_production_mesh

HBM_BYTES = 80e9           # NVIDIA H100 SXM data sheet: 80 GB of HBM3


def active_params(cfg: ModelConfig, specs) -> tuple[int, int]:
    """(total, active) param counts; MoE active = shared + top_k/E routed."""
    total = expert = 0
    for path, s in nnspec.tree_paths(specs):
        total += s.size
        if "/moe/wi" in path or "/moe/wo" in path:
            expert += s.size
    if cfg.n_experts and expert:
        active = total - expert + expert * cfg.top_k / cfg.n_experts
    else:
        active = total
    return total, int(active)


def pick_microbatches(cfg: ModelConfig, shape: ShapeConfig, mesh) -> int:
    """Activation-memory heuristic: keep per-device microbatch tokens
    around <= 64k for wide models."""
    per_dev_batch = max(shape.global_batch // shd.data_size(mesh), 1)
    tokens = per_dev_batch * shape.seq_len
    if cfg.d_model >= 8192:
        target = 4096
    elif cfg.d_model >= 4096:
        target = 8192
    else:
        target = 16384
    micro = max(1, tokens // target)
    micro = min(micro, per_dev_batch)
    while per_dev_batch % micro and micro > 1:
        micro -= 1
    return micro


def _per_device(spec_tree, rules, mesh, itemsize=None) -> int:
    """Bytes of one device's shards of ``spec_tree``'s leaves (each leaf's
    own dtype, or ``itemsize`` bytes an element)."""
    total = 0
    for _, s in nnspec.tree_paths(spec_tree):
        spec = nnspec._partition_spec(s, rules, mesh)
        if itemsize is None:
            total += nnspec.shard_bytes(s, spec, mesh)
        else:
            total += math.prod(nnspec.shard_shape(s, spec, mesh)) * itemsize
    return total


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """Trace one cell's step (``remat``, as the JAX dry run lowers it) on
    fake tensors; the per-device numbers."""
    remat = True
    fam = get_family(cfg)
    rules = shd.make_rules(mesh, batch=shape.global_batch)
    pspecs = fam.param_specs(cfg)
    b_axes = shd.batch_axes(mesh, shape.global_batch)
    b_shards = math.prod(mesh.shape[a] for a in b_axes) if b_axes else 1
    micro = 1
    if shape.kind == "train":
        micro = pick_microbatches(cfg, shape, mesh)
    rows = shape.global_batch // micro
    mode = FakeTensorMode()
    counter = StepCounter()
    params = fake_tree(pspecs, mode, requires_grad=(shape.kind == "train"))
    in_shapes = steps_lib.batch_shapes(cfg, shape.seq_len, rows, shape.kind)
    with mode:
        batch = {k: torch.empty(s, dtype=nnspec.torch_dtype(dt))
                 for k, (s, dt) in in_shapes.items()}
    mem: dict[str, float] = {"param_bytes": _per_device(pspecs, rules, mesh)}
    if shape.kind == "train":
        ospecs = opt_lib.state_specs(pspecs, opt_lib.OptConfig())
        mem["opt_state_bytes"] = _per_device(ospecs, rules, mesh)
        mem["grad_bytes"] = _per_device(pspecs, rules, mesh,
                                        itemsize=4 if micro > 1 else None)
        with mode, counter:
            fam.loss(cfg, params, batch, remat=remat).backward()
        # the traced peak holds the global gradients as they form; a
        # device's share of them is counted from the specs above
        grads_global = sum(s.nbytes for _, s in nnspec.tree_paths(pspecs))
        transient = max(counter.peak - grads_global, 0)
    else:
        cspecs = fam.cache_specs(cfg, shape.global_batch, shape.seq_len)
        mem["cache_bytes"] = _per_device(cspecs, rules, mesh)
        cache = fake_tree(cspecs, mode)
        with mode, counter, torch.no_grad():
            if shape.kind == "prefill":
                steps_lib.build_prefill_step(cfg)(params, batch, cache)
            else:
                steps_lib.build_decode_step(cfg)(params, cache, batch,
                                                 shape.seq_len - 1)
        transient = counter.peak
    mem["input_bytes"] = sum(math.prod(s) * nnspec.itemsize(dt)
                             for s, dt in in_shapes.values()) * micro / b_shards
    mem["activation_bytes"] = transient / b_shards
    traced = counter.result()
    n_chips = mesh.size
    total_p, active_p = active_params(cfg, pspecs)
    coll = fsdp_collectives(pspecs, rules, mesh, kind=shape.kind,
                            microbatches=micro, remat=remat)
    state = ("param_bytes", "grad_bytes", "cache_bytes", "input_bytes")
    roof = Roofline(flops=traced["dot_flops"] * micro / n_chips,
                    min_hbm_bytes=sum(mem.get(k, 0) for k in state),
                    coll_bytes=float(sum(coll["bytes"].values())),
                    n_chips=n_chips,
                    model_flops=model_flops(cfg, shape, total_p, active_p))
    peak = sum(mem.values())
    return {
        "n_chips": n_chips, "params_total": total_p, "params_active": active_p,
        "meta": {"microbatches": micro, "traced_batch": rows, "remat": remat,
                 "batch_shards": b_shards},
        "memory_per_device": mem, "peak_bytes_per_device": peak,
        "fits_hbm": bool(peak < HBM_BYTES),
        "collectives": {**coll, "not_modelled": "tensor-parallel activation "
                        "collectives (the port has no SPMD partitioner)"},
        "traced": traced, "roofline": roof.to_dict(),
    }


def _write(result: dict, out_dir: str) -> None:
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    fn = f"{result['arch']}__{result['shape']}__{result['mesh']}.json"
    with open(os.path.join(out_dir, fn), "w") as f:
        json.dump(result, f, indent=1)


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str, *,
             cfg: ModelConfig | None = None,
             shape: ShapeConfig | None = None) -> dict:
    """One cell: ``ARCHS[arch]`` (or ``cfg``) at ``SHAPES[shape_name]``
    (or ``shape``) on the single- or multi-pod mesh.  A failure is written
    as ``status: "error"`` with its traceback."""
    cfg = cfg or ARCHS[arch]
    shape = shape or SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_kind}
    if not ok:
        result.update(status="skipped", reason=why)
        _write(result, out_dir)
        return result
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    t0 = time.perf_counter()
    try:
        result.update(status="ok", **trace_cell(cfg, shape, mesh))
        result["trace_s"] = time.perf_counter() - t0
    except Exception as e:  # a failure here is a bug in the system
        result.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
    _write(result, out_dir)
    return result


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="dry run on fake tensors")
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", choices=["all", *SHAPES])
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mk in meshes:
                r = run_cell(arch, shape, mk, args.out)
                if r["status"] == "ok":
                    roof = r["roofline"]
                    print(f"[ok     ] {arch} x {shape} x {mk}: "
                          f"peak/dev={r['peak_bytes_per_device']/1e9:.2f}GB "
                          f"bottleneck={roof['bottleneck']} "
                          f"step={roof['step_s']*1e3:.1f}ms "
                          f"(trace {r['trace_s']:.0f}s)", flush=True)
                elif r["status"] == "skipped":
                    print(f"[skipped] {arch} x {shape} x {mk}: {r['reason']}")
                else:
                    failures += 1
                    print(f"[ERROR  ] {arch} x {shape} x {mk}: {r['error']}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
