"""The port's distributed and launch tooling against the JAX package's, on
the CPU at small sizes.

* Partition rules: every leaf of every config's param, cache and
  optimizer-state specs gets the JAX package's partition spec on the
  2 x 16 x 16, 16 x 16 and 1 x 1 meshes, and the rule cases of
  ``tests/test_sharding.py`` hold.
* Compression: ``quantize_int8``, ``ef_compress``, ``ef_compress_tree`` and
  the one-rank ``ef_psum`` are bitwise the JAX package's; two gloo ranks
  give the JAX formula, the largest-scale fault of ROADMAP C5 included.
* Step analysis: dot FLOPs by ``analyze_hlo``'s rule, live-byte peaks, and
  the roofline under the H100's data sheet.
* Elastic restore: ``restore_for_mesh`` is bitwise the JAX package's.
* Dry run: a cell per family through ``run_cell``; the CLI's files.
* Analysis: the port's copy finds what the JAX package's finds over the
  port, and its sanitizer wraps the port's locks through a concurrent
  cold start.
"""
import json
import os
import threading
import time
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import SMOKES as JAX_SMOKES  # noqa: E402
from repro.distributed import compress as jax_compress  # noqa: E402
from repro.distributed import sharding as jax_shd  # noqa: E402
from repro.distributed.hlo_analysis import analyze_hlo  # noqa: E402
from repro.models import get_family as jax_family  # noqa: E402
from repro.nn import spec as jax_spec  # noqa: E402
from repro.training import optimizer as jax_opt  # noqa: E402
from repro.training.checkpoint import restore_for_mesh as jax_restore_for_mesh  # noqa: E402
from repro_torch.configs import ARCHS, SMOKES  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.distributed import compress  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed import step_analysis  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (Mesh, make_production_mesh,  # noqa: E402
                                     make_smoke_mesh)
from repro_torch.models import get_family  # noqa: E402
from repro_torch.nn import spec as nnspec  # noqa: E402
from repro_torch.training import optimizer as opt_lib  # noqa: E402
from repro_torch.training.checkpoint import restore_for_mesh, save_checkpoint  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")

MESHES = {
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "1x1": ((1, 1), ("data", "model")),
}


def _meshes(name):
    """The port's mesh and the JAX package's stand-in (``test_sharding``'s
    ``SimpleNamespace``) of one shape."""
    sizes, names = MESHES[name]
    shape = dict(zip(names, sizes))
    return Mesh(shape), SimpleNamespace(shape=shape, axis_names=names)


# -- partition rules ---------------------------------------------------------


def _spec_pairs(port_tree, jax_tree, port_rules, jax_rules, port_mesh, jax_mesh):
    jp = dict(jax_spec.tree_paths(jax_tree))
    pairs = []
    for path, s in nnspec.tree_paths(port_tree):
        js = jp.pop(path)
        assert (s.shape, s.axes) == (js.shape, js.axes), path
        pairs.append((path, nnspec._partition_spec(s, port_rules, port_mesh),
                      jax_spec._partition_spec(js, jax_rules, jax_mesh)))
    assert not jp, f"leaves only in the JAX tree: {sorted(jp)[:5]}"
    return pairs


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_partition_specs_match_jax(arch, mesh_name):
    pm, jm = _meshes(mesh_name)
    cfg, jcfg = ARCHS[arch], JAX_ARCHS[arch]
    fam, jfam = get_family(cfg), jax_family(jcfg)
    pr, jr = shd.make_rules(pm, batch=128), jax_shd.make_rules(jm, batch=128)
    assert pr == jr
    assert shd.batch_pspec(pm, 128) == tuple(jax_shd.batch_pspec(jm, 128))
    pspecs, jpspecs = fam.param_specs(cfg), jfam.param_specs(jcfg)
    trees = [
        (pspecs, jpspecs),
        (fam.cache_specs(cfg, 128, 32768), jfam.cache_specs(jcfg, 128, 32768)),
        (opt_lib.state_specs(pspecs, opt_lib.OptConfig()),
         jax_opt.state_specs(jpspecs, jax_opt.OptConfig())),
    ]
    n = 0
    for pt, jt in trees:
        for path, p, j in _spec_pairs(pt, jt, pr, jr, pm, jm):
            assert tuple(p) == tuple(j), (path, p, j)
            n += 1
    assert n > 0


RULES = {"heads": "model", "kv_heads": "model", "mlp": "model",
         "vocab": "model", "embed": ("pod", "data"), "batch": ("pod", "data"),
         "seq": "model", "layers": None}
BIG = Mesh({"pod": 2, "data": 16, "model": 16})


def _basic():
    p = nnspec._partition_spec(nnspec.tensor(8192, 64, 128, axes=("embed", "heads", "head_dim")),
                               RULES, BIG)
    assert p[0] == ("pod", "data") and p[1] == "model"


def _divisibility_fallback():
    p = nnspec._partition_spec(nnspec.tensor(80, 8, 128, axes=("layers", "kv_heads", "head_dim")),
                               RULES, BIG)
    assert all(e is None for e in p)


def _no_axis_reuse():
    p = nnspec._partition_spec(nnspec.tensor(64, 128, axes=("heads", "seq")), RULES, BIG)
    assert p[0] == "model" and (len(p) < 2 or p[1] is None)


def _prefix_drop():
    p = nnspec._partition_spec(nnspec.tensor(2, 128, axes=("embed", None)), RULES, BIG)
    assert p[0] == "pod"


def _always_divides():
    for dim in range(1, 4097):
        p = nnspec._partition_spec(nnspec.tensor(dim, axes=("embed",)), RULES, BIG)
        if p and p[0] is not None:
            axes = p[0] if isinstance(p[0], tuple) else (p[0],)
            assert dim % int(np.prod([BIG.shape[a] for a in axes])) == 0


def _batch_axes():
    assert shd.batch_axes(BIG, 256) == ("pod", "data")
    assert shd.batch_axes(BIG, 16) == ("data",)
    assert shd.batch_axes(BIG, 1) is None


@pytest.mark.parametrize("case", [_basic, _divisibility_fallback, _no_axis_reuse,
                                  _prefix_drop, _always_divides, _batch_axes],
                         ids=lambda f: f.__name__.strip("_"))
def test_rule_cases(case):
    case()


def test_meshes_and_shardings():
    single, multi, smoke = (make_production_mesh(), make_production_mesh(multi_pod=True),
                            make_smoke_mesh())
    assert (single.axis_names, single.size) == (("data", "model"), 256)
    assert (multi.axis_names, multi.size) == (("pod", "data", "model"), 512)
    assert (smoke.shape, smoke.size) == ({"data": 1, "model": 1}, 1)
    s = nnspec.tensor(4096, 64, 128, axes=("embed", "heads", "head_dim"))
    sh = nnspec.shardings({"w": s}, multi, shd.make_rules(multi))["w"]
    assert sh.mesh is multi and sh.spec == (("pod", "data"), "model")
    assert nnspec.shard_shape(s, sh.spec, multi) == (128, 4, 128)
    assert nnspec.shard_bytes(s, sh.spec, multi) == 128 * 4 * 128 * 2
    x = torch.ones(3)
    shd.set_activation_rules(multi, 256)
    try:
        assert all(f(x) is x for f in (shd.act_batch, shd.act_logits,
                                       shd.act_heads, shd.act_expert))
    finally:
        shd.set_activation_rules(None)
    assert shd.replicated(multi).spec == ()


# -- compression -------------------------------------------------------------


def _bits(t):
    return np.asarray(t).tobytes()


SCALES = [1e-3, 3e-2, 1.0, 30.0, 1e3]


def _grads_and_errors(scale):
    rng = np.random.default_rng(int(scale * 1000))
    g = {"a": (rng.standard_normal((33, 17)) * scale).astype(np.float32),
         "b": {"c": (rng.standard_normal(64) * scale).astype(np.float32),
               "d": np.float32(rng.standard_normal() * scale)}}
    e = {"a": (rng.standard_normal((33, 17)) * scale * 1e-3).astype(np.float32),
         "b": {"c": np.zeros(64, np.float32), "d": np.float32(0.0)}}
    return g, e


def _torch_tree(tree):
    return opt_lib.tree_map(lambda a: torch.from_numpy(np.asarray(a)), tree)


def _pick(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("scale", SCALES)
def test_compression_bitwise_jax(scale):
    g, e = _grads_and_errors(scale)
    q, s = compress.quantize_int8(torch.from_numpy(g["a"]))
    jq, js = jax_compress.quantize_int8(jnp.asarray(g["a"]))
    assert _bits(q.numpy()) == _bits(jq) and _bits(s.numpy()) == _bits(js)
    out = compress.ef_compress(torch.from_numpy(g["a"]), torch.from_numpy(e["a"]))
    jout = jax_compress.ef_compress(jnp.asarray(g["a"]), jnp.asarray(e["a"]))
    for o, j in zip(out, jout):
        assert _bits(o.numpy()) == _bits(j)
    trees = compress.ef_compress_tree(_torch_tree(g), _torch_tree(e))
    jtrees = jax_compress.ef_compress_tree(jax.tree.map(jnp.asarray, g),
                                           jax.tree.map(jnp.asarray, e))
    for t, jt in zip(trees, jtrees):
        for path, leaf in opt_lib.tree_leaves(t):
            assert _bits(leaf.numpy()) == _bits(_pick(jt, path)), path
    deq = compress.decompress_tree(trees[0], trees[1])
    jdeq = jax_compress.decompress_tree(jtrees[0], jtrees[1])
    for path, leaf in opt_lib.tree_leaves(deq):
        assert _bits(leaf.numpy()) == _bits(_pick(jdeq, path)), path


def test_one_rank_ef_psum_bitwise_jax():
    """With no process group, ``ef_psum`` is the local compression, and the
    JAX package's ``ef_psum`` on a 1 x 1 mesh: a tree of a matrix at the
    smallest scale, a vector at the largest and a scalar."""
    (lo, elo), (hi, ehi) = _grads_and_errors(SCALES[0]), _grads_and_errors(SCALES[-1])
    g = {"lo": lo["a"], "hi": {"c": hi["b"]["c"], "d": hi["b"]["d"]}}
    e = {"lo": elo["a"], "hi": {"c": ehi["b"]["c"], "d": ehi["b"]["d"]}}
    tg, te = _torch_tree(g), _torch_tree(e)
    mean, errs = compress.ef_psum(tg, te)
    qs, scales, local_errs = compress.ef_compress_tree(tg, te)
    local = compress.decompress_tree(qs, scales)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    jmean, jerrs = jax_compress.ef_psum(jax.tree.map(jnp.asarray, g),
                                        jax.tree.map(jnp.asarray, e), jmesh, ("data",))
    errs, local_errs = dict(opt_lib.tree_leaves(errs)), dict(opt_lib.tree_leaves(local_errs))
    for path, leaf in opt_lib.tree_leaves(mean):
        assert (_bits(leaf.numpy()) == _bits(_pick(jmean, path))
                == _bits(_pick(local, path).numpy())), path
        assert (_bits(errs[path].numpy()) == _bits(_pick(jerrs, path))
                == _bits(local_errs[path].numpy())), path


def test_ef_psum_hands_the_collectives_contiguous_tensors(monkeypatch):
    """NCCL refuses a strided tensor, and autograd gives strided gradients
    (a transposed weight's): each payload and scale reaches ``all_reduce``
    contiguous.  gloo copies strided tensors itself, so this is checked on
    the calls."""
    seen = []

    def all_reduce(t, op=None, group=None):
        seen.append((t.is_contiguous(), t.dtype, op))
    monkeypatch.setattr(compress.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(compress.dist, "get_world_size", lambda group=None: 1)
    monkeypatch.setattr(compress.dist, "all_reduce", all_reduce)
    g = torch.randn(20, 9).t()
    assert not g.is_contiguous()
    mean, _ = compress.ef_psum({"w": g}, {"w": torch.zeros_like(g)})
    assert seen == [(True, torch.int32, compress.dist.ReduceOp.SUM),
                    (True, torch.float32, compress.dist.ReduceOp.MAX)]
    q, s = compress.quantize_int8(g)
    assert torch.equal(mean["w"], compress.dequantize_int8(q, s))


def _gloo_worker(rank: int, world: int, store_path: str, out_dir: str, cases):
    import torch.distributed as dist
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        for name, per_rank in cases.items():
            g = torch.from_numpy(per_rank[rank])
            if name == "strided":               # a transposed gradient, as autograd gives
                g = g.t()
            mean, err = compress.ef_psum({"g": g}, {"g": torch.zeros_like(g)})
            np.save(os.path.join(out_dir, f"{name}_{rank}_mean.npy"), mean["g"].numpy())
            np.save(os.path.join(out_dir, f"{name}_{rank}_err.npy"), err["g"].numpy())
    finally:
        dist.destroy_process_group()


def _jax_formula(per_rank):
    """``ef_psum``'s arithmetic in numpy: each rank's int8 payload at its
    own scale, summed, times the largest scale, over the rank count."""
    qs, scales, errs = [], [], []
    for g in per_rank:
        s = np.float32(max(np.float32(np.max(np.abs(g))), np.float32(1e-12))) / np.float32(127.0)
        q = np.clip(np.round(g / s), -127, 127).astype(np.int8)
        qs.append(q.astype(np.int32))
        scales.append(np.float32(s))
        errs.append(g - q.astype(np.float32) * np.float32(s))
    acc = np.sum(qs, axis=0).astype(np.float32)
    return acc * max(scales) / np.float32(len(per_rank)), errs


def test_ef_psum_two_gloo_ranks(tmp_path):
    import torch.multiprocessing as mp
    rng = np.random.default_rng(7)
    cases = {
        "random": [(rng.standard_normal(257) * s).astype(np.float32) for s in (0.5, 3.0)],
        "strided": [(rng.standard_normal((9, 20)) * s).astype(np.float32) for s in (1.0, 2.0)],
        # ROADMAP C5: 127 at scale 1 and 254 at scale 2 give 254, not 190.5
        "c5": [np.array([127.0], np.float32), np.array([254.0], np.float32)],
    }
    ctx = mp.spawn(_gloo_worker, args=(2, str(tmp_path / "store"), str(tmp_path), cases),
                   nprocs=2, join=False)
    deadline = time.monotonic() + 60.0
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("two gloo ranks did not finish within 60 s")
    for name, per_rank in cases.items():
        if name == "strided":
            per_rank = [g.T for g in per_rank]
        want, want_errs = _jax_formula(per_rank)
        for r in range(2):
            got = np.load(tmp_path / f"{name}_{r}_mean.npy")
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(np.load(tmp_path / f"{name}_{r}_err.npy"),
                                          want_errs[r])
    c5 = np.load(tmp_path / "c5_0_mean.npy")
    assert c5.tolist() == [254.0]                     # the true mean is 190.5


# -- step analysis -----------------------------------------------------------


def test_dot_flops_match_analyze_hlo():
    def body(i, acc):
        x = jnp.full((8, 128), i, jnp.float32) + acc[0, 0]
        return acc + x @ jnp.ones((128, 8), jnp.float32)
    f = jax.jit(lambda a: jax.lax.fori_loop(0, 10, body, a))
    hlo = f.lower(jnp.zeros((8, 8), jnp.float32)).compile().as_text()
    want = analyze_hlo(hlo)["dot_flops_per_device"]
    counter = step_analysis.StepCounter()
    with torch._subclasses.fake_tensor.FakeTensorMode(), counter:
        acc = torch.zeros(8, 8)
        for i in range(10):
            acc = acc + (torch.full((8, 128), float(i)) + acc[0, 0]) @ torch.ones(128, 8)
    assert counter.dot_flops == want == 2 * 64 * 128 * 10


def test_step_counter_bytes_and_peak():
    counter = step_analysis.StepCounter()
    with torch._subclasses.fake_tensor.FakeTensorMode(), counter:
        a = torch.ones(1000)              # 4000 B
        b = a * 2                         # 4000 B, peak 8000
        v = b[10:]                        # a view: nothing written
        del a
        c = torch.ones(500)               # 2000 B: live 6000
        b.add_(1)                         # in place: 4000 B written, no buffer
    r = counter.result()
    assert counter.peak == 8000 and counter.live == 6000
    assert r["eager_written_bytes"] == 4000 + 4000 + 2000 + 4000
    assert v.shape == (990,) and c.shape == (500,)


def test_step_counter_agrees_with_flop_counter_on_a_family():
    from torch.utils.flop_counter import FlopCounterMode
    cfg = SMOKES["olmo-1b"]
    mode = torch._subclasses.fake_tensor.FakeTensorMode()
    params = step_analysis.fake_tree(get_family(cfg).param_specs(cfg), mode,
                                     requires_grad=True)
    with mode:
        batch = {"tokens": torch.zeros((2, 64), dtype=torch.int32)}
    counter, fc = step_analysis.StepCounter(), FlopCounterMode(display=False)
    with mode, fc, counter:
        get_family(cfg).loss(cfg, params, batch, remat=True).backward()
    assert counter.dot_flops == fc.get_total_flops() > 0


def test_roofline_terms_h100():
    R = step_analysis
    assert (R.PEAK_FLOPS, R.HBM_BW, R.NVLINK_BW) == (989e12, 3.35e12, 450e9)
    r = R.Roofline(flops=R.PEAK_FLOPS, min_hbm_bytes=R.HBM_BW / 2, coll_bytes=R.NVLINK_BW / 4,
                   n_chips=4, model_flops=2 * R.PEAK_FLOPS)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(0.5)
    assert r.collective_s == pytest.approx(0.25)
    assert r.bottleneck == "compute"
    assert r.roofline_fraction == pytest.approx(0.5)
    assert r.useful_flops_ratio == pytest.approx(0.5)


# -- elastic restore ---------------------------------------------------------


@pytest.mark.parametrize("n_hosts", [2, 4, 8])
def test_restore_for_mesh_bitwise_jax(tmp_path, n_hosts):
    specs = {"w": nnspec.tensor(16, 8, dtype="bfloat16"),     # divides 2, 4, 8
             "odd": nnspec.tensor(10, 3, dtype="float32"),    # rows do not divide
             "few": nnspec.tensor(3, 5, dtype="float32"),     # fewer rows than shards
             "s": nnspec.TensorSpec((), "float32")}           # a scalar
    jspecs = {"w": jax_spec.tensor(16, 8, dtype=jnp.bfloat16),
              "odd": jax_spec.tensor(10, 3, dtype=jnp.float32),
              "few": jax_spec.tensor(3, 5, dtype=jnp.float32),
              "s": jax_spec.TensorSpec((), jnp.float32)}
    params = nnspec.stream_initialize(specs, seed=5)
    params["s"] = torch.tensor(1.5)
    base = save_checkpoint(str(tmp_path / "ck"), params, {}, 3)
    mesh = Mesh({"data": n_hosts, "model": 2})
    stats: dict = {}
    got = restore_for_mesh(base, specs, mesh, shd.make_rules(mesh), device="cpu",
                           stats=stats)
    want = jax_restore_for_mesh(base, jspecs,
                                SimpleNamespace(shape=dict(mesh.shape),
                                                axis_names=mesh.axis_names), {})
    for k in specs:
        assert got[k].dtype == params[k].dtype and got[k].shape == params[k].shape
        assert _bits(got[k].view(torch.int16).numpy() if got[k].dtype == torch.bfloat16
                     else got[k].numpy()) == _bits(want[k]), k
        assert torch.equal(got[k], params[k])
    assert stats["bytes"] == sum(s.nbytes for s in specs.values())
    assert stats["reads"] == (2 * n_hosts + (n_hosts if n_hosts <= 3 else 1) + 1)


def test_restore_for_mesh_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    specs = {"w": nnspec.tensor(4, 4, dtype="float32")}
    base = save_checkpoint(str(tmp_path / "ck"), nnspec.stream_initialize(specs), {}, 1)
    with pytest.raises(RuntimeError, match="no usable CUDA device"):
        restore_for_mesh(base, specs, Mesh({"data": 2}), {})


# -- dry run -----------------------------------------------------------------


def _jax_counts(jcfg):
    total = expert = 0
    for path, s in jax_spec.tree_paths(jax_family(jcfg).param_specs(jcfg)):
        total += s.size
        if "/moe/wi" in path or "/moe/wo" in path:
            expert += s.size
    active = (total - expert + expert * jcfg.top_k / jcfg.n_experts
              if jcfg.n_experts and expert else total)
    return total, int(active)


def _jax_param_bytes(jcfg, jmesh, batch):
    rules = jax_shd.make_rules(jmesh, batch=batch)
    total = 0
    for _, s in jax_spec.tree_paths(jax_family(jcfg).param_specs(jcfg)):
        p = jax_spec._partition_spec(s, rules, jmesh)
        shape = list(s.shape)
        for i, e in enumerate(p):
            for a in ((e,) if isinstance(e, str) else (e or ())):
                shape[i] //= jmesh.shape[a]
        total += int(np.prod(shape)) * jnp.dtype(s.dtype).itemsize
    return total


FAMILY_CELLS = [("olmo-1b", "train"), ("pixtral-12b", "train"),
                ("deepseek-moe-16b", "train"), ("zamba2-1.2b", "train"),
                ("rwkv6-7b", "train"), ("seamless-m4t-medium", "train"),
                ("olmo-1b", "prefill"), ("olmo-1b", "decode")]


@pytest.mark.parametrize("arch,kind", FAMILY_CELLS)
def test_dryrun_cell_per_family(tmp_path, arch, kind):
    shape = ShapeConfig(f"{kind}_small", 128, 32, kind)
    r = dryrun.run_cell(arch, shape.name, "single", str(tmp_path), cfg=SMOKES[arch],
                        shape=shape)
    assert r["status"] == "ok", r.get("traceback")
    assert (r["params_total"], r["params_active"]) == _jax_counts(JAX_SMOKES[arch])
    _, jmesh = _meshes("16x16")
    mem = r["memory_per_device"]
    assert mem["param_bytes"] == _jax_param_bytes(JAX_SMOKES[arch], jmesh, 32)
    assert r["n_chips"] == 256 and r["trace_s"] > 0
    assert r["traced"]["dot_flops"] > 0 and r["traced"]["peak_live_bytes"] > 0
    assert r["peak_bytes_per_device"] == pytest.approx(sum(mem.values()))
    roof = r["roofline"]
    assert roof["bottleneck"] in ("compute", "memory", "collective")
    state = ("param_bytes", "grad_bytes", "cache_bytes", "input_bytes")
    assert roof["min_hbm_bytes_per_device"] == sum(mem.get(k, 0) for k in state)
    if kind == "train":
        assert {"opt_state_bytes", "grad_bytes"} <= set(mem)
        assert r["collectives"]["count"]["reduce-scatter"] > 0
    else:
        assert "cache_bytes" in mem and r["collectives"]["bytes"]["reduce-scatter"] == 0
    with open(tmp_path / f"{arch}__{shape.name}__single.json") as f:
        assert json.load(f)["params_total"] == r["params_total"]


def test_dryrun_cli_writes_skipped_and_error_cells(tmp_path, monkeypatch):
    out = str(tmp_path / "dr")
    assert dryrun.main(["--arch", "olmo-1b", "--shape", "long_500k", "--mesh", "both",
                        "--out", out]) == 0
    for mk in ("single", "multi"):
        with open(os.path.join(out, f"olmo-1b__long_500k__{mk}.json")) as f:
            assert json.load(f)["status"] == "skipped"

    def boom(*a, **kw):
        raise RuntimeError("traced nothing")
    monkeypatch.setattr(dryrun, "trace_cell", boom)
    assert dryrun.main(["--arch", "olmo-1b", "--shape", "train_4k", "--mesh", "single",
                        "--out", out]) == 1
    with open(os.path.join(out, "olmo-1b__train_4k__single.json")) as f:
        r = json.load(f)
    assert r["status"] == "error" and "traced nothing" in r["traceback"]


@pytest.mark.parametrize("arch,single,multi", [("olmo-1b", 4, 2), ("qwen2-7b", 4, 2),
                                                ("qwen1.5-110b", 16, 8)])
def test_pick_microbatches(arch, single, multi):
    """The JAX package's heuristic (its module sets ``XLA_FLAGS`` at import,
    so the expected counts are worked out here): 16 (single) or 8 (multi)
    sequences of 4096 per device, over 16384 tokens a microbatch below
    d_model 4096 and 4096 tokens from d_model 8192."""
    from repro_torch.configs import SHAPES
    got = [dryrun.pick_microbatches(ARCHS[arch], SHAPES["train_4k"],
                                    make_production_mesh(multi_pod=m)) for m in (False, True)]
    assert got == [single, multi]


# -- analysis ----------------------------------------------------------------


def test_port_analysis_finds_the_accepted_findings():
    from test_torch_cluster import ACCEPTED

    from repro.analysis import run_all as jax_run_all
    from repro_torch.analysis import run_all
    keys = {f.key for f in run_all(PORT)}
    assert keys == set(ACCEPTED)
    assert keys == {f.key for f in jax_run_all(PORT)}


@pytest.fixture
def port_sanitizer():
    from repro_torch.analysis import sanitizer
    was_enabled, was_raising = sanitizer.enabled(), sanitizer.STATE.raise_on_violation
    sanitizer.STATE.reset()
    sanitizer.STATE.raise_on_violation = False
    sanitizer.enable()
    try:
        yield sanitizer
    finally:
        if not was_enabled:
            sanitizer.disable()
        sanitizer.STATE.reset()
        sanitizer.STATE.raise_on_violation = was_raising


def test_port_sanitizer_over_a_concurrent_cold_start(tmp_path, port_sanitizer):
    from repro_torch.core import pagestore, reap
    from repro_torch.serving import Orchestrator, ServeConfig
    mine = threading.Lock()
    assert not isinstance(mine, port_sanitizer.SanitizedLock)
    cfg = SMOKES["olmo-1b"]
    batch = {"tokens": np.random.default_rng(0).integers(0, cfg.vocab, (2, 32),
                                                         dtype=np.int32)}
    orch = Orchestrator(str(tmp_path), ServeConfig(device="cpu"))
    try:
        assert isinstance(orch._lock, port_sanitizer.SanitizedLock)
        orch.register("fn", cfg)
        record, rep = orch.invoke("fn", batch)
        assert rep.n_prefetched_pages == 0
        orch.scale_to_zero("fn")
        out, errors = [None, None], []

        def cold(i):
            try:
                out[i] = orch.invoke("fn", batch)
            except BaseException as e:          # reported below
                errors.append(e)
        threads = [threading.Thread(target=cold, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors, errors
        assert all(o is not None for o in out)
        for logits, rep in out:
            assert torch.equal(logits, record)
        assert any(rep.n_prefetched_pages > 0 for _, rep in out)
    finally:
        orch.close()
        pagestore.reset_stores()
        reap.WS_CACHE.clear()
    assert port_sanitizer.STATE.edges, "no sanitized lock was taken under another"
    assert port_sanitizer.STATE.violations == [], [
        port_sanitizer.render_violation(v) for v in port_sanitizer.STATE.violations]
