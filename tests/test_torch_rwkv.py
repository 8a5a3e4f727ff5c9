"""The port's RWKV6 family against the JAX package's, and the WKV6 kernel
against its plain version.

The plain WKV6 scan is held to the JAX oracle (``wkv6_scan_ref``, a step by
step recurrence), to the Pallas kernel in interpret mode (``ops.wkv6``)
and to the model's ``wkv6_chunked``, at the shapes of
``tests/test_kernels.py``.  rwkv6-7b SMOKE runs forward, prefill and decode
in both packages from the same ``host_initialize`` parameters; its
snapshot, record trace and working set through the port's ``Orchestrator``
are the JAX package's, byte for byte.  Tests marked ``cuda`` hold the CUDA
kernel to its plain version; they skip without a card.  JAX is imported
inside the fixture, so ``-m cuda`` runs where JAX is absent.
"""
import dataclasses
import filecmp
import math
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import ARCHS, SMOKES  # noqa: E402
from repro_torch.core import pagestore, reap  # noqa: E402
from repro_torch.core.snapshot import build_instance_snapshot  # noqa: E402
from repro_torch.kernels import LAUNCHES, wkv6  # noqa: E402
from repro_torch.kernels.rwkv6_scan import wkv6_ref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import rwkv6  # noqa: E402
from repro_torch.nn import spec  # noqa: E402
from repro_torch.serving import Orchestrator, ServeConfig  # noqa: E402

from test_torch_decode import (B, BF16_ATOL, PROMPT, STEPS, _f32, _f32_tree,  # noqa: E402
                               run_jax, run_port, tokens_for)

NAME = "rwkv6-7b"
WKV_SHAPES = [                       # tests/test_kernels.py:100-104 (B,L,H,D,chunk)
    (2, 128, 4, 64, 32),
    (1, 256, 2, 32, 64),
    (2, 96, 8, 16, 16),
]
WKV_ATOL = 1e-3                      # tests/test_kernels.py:124


@pytest.fixture(scope="module")
def jx():
    """The JAX package's RWKV6 model, steps and WKV6 kernels (skips where
    JAX is absent)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import SMOKES as JAX_SMOKES
    from repro.core import pagestore as jax_pagestore
    from repro.core import reap as jax_reap
    from repro.core.snapshot import build_instance_snapshot as jax_build
    from repro.kernels.rwkv6_scan.ops import wkv6 as jax_wkv6
    from repro.kernels.rwkv6_scan.ref import wkv6_scan_ref as jax_ref
    from repro.launch import steps as jax_steps
    from repro.models import rwkv6 as jax_rwkv6
    from repro.nn import spec as jax_spec
    from repro.serving import Orchestrator as JaxOrchestrator
    from repro.serving import ServeConfig as JaxServeConfig
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, smokes=JAX_SMOKES, steps=jax_steps, spec=jax_spec,
        rwkv6=jax_rwkv6, wkv6=jax_wkv6, ref=jax_ref, build=jax_build,
        pagestore=jax_pagestore, reap=jax_reap, Orchestrator=JaxOrchestrator,
        ServeConfig=JaxServeConfig)


@pytest.fixture
def cuda():
    """The CUDA device, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def wkv_inputs(B_, L, H, D, seed=42, logw_range=None):
    """r, k, v, logw, u, s0 as float32 numpy arrays (the value ranges of
    tests/test_kernels.py: log decay -|N(0, 0.5)| - 0.05, u and s0 not 0).
    With ``logw_range`` (lo, hi), the log decay is uniform in it instead
    (strong decay)."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    out = [r(B_, L, H, D), r(B_, L, H, D, scale=0.3), r(B_, L, H, D),
           -np.abs(r(B_, L, H, D, scale=0.5)) - 0.05, r(H, D, scale=0.2),
           r(B_, H, D, D, scale=0.1)]
    if logw_range is not None:
        out[3] = rng.uniform(*logw_range, (B_, L, H, D)).astype(np.float32)
    return tuple(out)


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


# -- the WKV6 scan: plain version against the JAX package ---------------------


@pytest.mark.parametrize("B_,L,H,D,chunk", WKV_SHAPES)
def test_plain_wkv6_matches_jax(jx, B_, L, H, D, chunk):
    jnp = jx.jnp
    arrs = wkv_inputs(B_, L, H, D)
    y, sT = wkv6(*_t(arrs), chunk=chunk)
    assert y.dtype == sT.dtype == torch.float32
    j = [jnp.asarray(a) for a in arrs]
    r, k, v, logw, u, s0 = arrs

    def flat(a):
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(B_ * H, L, D))
    # the step-by-step oracle, in the kernel's flattened (b*h) layout
    ry, rsT = jx.ref(flat(r), flat(k), flat(v), flat(logw), jnp.asarray(np.tile(u, (B_, 1))),
                     jnp.asarray(s0.reshape(B_ * H, D, D)))
    wants = [jx.wkv6(*j, chunk=chunk),                    # Pallas, interpret mode
             jx.rwkv6.wkv6_chunked(*j, chunk=chunk),     # the model's path
             (np.asarray(ry).reshape(B_, H, L, D).transpose(0, 2, 1, 3),
              np.asarray(rsT).reshape(B_, H, D, D))]
    for wy, wsT in wants:
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=WKV_ATOL)
        np.testing.assert_allclose(sT.numpy(), np.asarray(wsT), atol=WKV_ATOL)


@pytest.mark.parametrize("L", [1, 24, 50])
def test_wkv6_chunked_matches_jax(jx, L):
    """The model's scan at decode (L = 1), one ragged chunk and a padded
    second chunk, with the model's chunk rule."""
    jnp = jx.jnp
    arrs = wkv_inputs(2, L, 4, 16, seed=L)
    chunk = min(32, max(1, L))
    y, sT = wkv6(*_t(arrs), chunk=chunk)
    jy, jsT = jx.rwkv6.wkv6_chunked(*(jnp.asarray(a) for a in arrs), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(sT.numpy(), np.asarray(jsT), atol=1e-5, rtol=1e-5)


def test_wkv6_ref_is_chunk_invariant():
    """Chunk sizes that divide L, that leave a ragged chunk, 1 and L itself
    (tests/test_kernels.py:157-173, at its tolerance)."""
    r, k, v, logw, u, s0 = _t(wkv_inputs(1, 50, 2, 8, seed=7))
    s0 = torch.zeros_like(s0)
    y1, s1 = wkv6_ref(r, k, v, logw, u, s0, chunk=50)
    for chunk in (1, 7, 25, 64):
        y2, s2 = wkv6_ref(r, k, v, logw, u, s0, chunk=chunk)
        torch.testing.assert_close(y2, y1, atol=2e-4, rtol=0)
        torch.testing.assert_close(s2, s1, atol=2e-4, rtol=0)


def test_wkv6_rejects_bad_input():
    r, k, v, logw, u, s0 = _t(wkv_inputs(1, 8, 2, 16))
    with pytest.raises(ValueError):
        wkv6(r, k[:, :4], v, logw, u, s0)                     # L mismatch
    with pytest.raises(ValueError):
        wkv6(r, k, v, logw, u[:, :8], s0)                     # u's D
    with pytest.raises(ValueError):
        wkv6(r, k, v, logw, u, s0[0])                         # s0 rank
    with pytest.raises(ValueError):
        wkv6(r, k, v, logw, u, s0, chunk=0)
    with pytest.raises(ValueError, match="CUDA"):             # mixed devices
        wkv6(r.to("meta"), k, v, logw, u, s0)


# -- the RWKV6 model against the JAX package ------------------------------------


def test_rwkv_specs_match_jax(jx):
    """Parameter specs (and so the ``host_initialize`` bytes) and cache
    specs are the JAX package's."""
    cfg, jcfg = SMOKES[NAME], jx.smokes[NAME]

    def mine(tree):
        return {p: (s.shape, s.dtype, s.axes, s.init) for p, s in spec.tree_paths(tree)}

    def theirs(tree):
        return {p: (s.shape, str(np.dtype(s.dtype)), s.axes, s.init)
                for p, s in jx.spec.tree_paths(tree)}
    assert mine(steps.param_specs(cfg)) == theirs(jx.steps.param_specs(jcfg))
    assert mine(steps.cache_specs(cfg, 3, 40)) == theirs(jx.steps.cache_specs(jcfg, 3, 40))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv_forward_matches_jax(jx, dtype):
    jnp = jx.jnp
    cfg, jcfg = SMOKES[NAME], jx.smokes[NAME]
    tokens = tokens_for(NAME, seed=3)
    host = jx.spec.host_initialize(jx.steps.param_specs(jcfg), seed=3)
    cast = jnp.float32 if dtype == "float32" else None
    jparams = jx.spec.map_leaves(lambda p, s: jnp.asarray(host[p]).astype(cast or s.dtype),
                                 jx.steps.param_specs(jcfg))
    want = np.asarray(jx.jax.jit(jx.steps.build_forward(jcfg))(
        jparams, {"tokens": jnp.asarray(tokens)}), np.float32)
    params = steps.init_params(cfg, 3, "cpu")
    if dtype == "float32":
        params = _f32_tree(params)
    got = steps.build_forward(cfg)(params, {"tokens": tokens})
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == want.shape
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == "float32" else dict(atol=BF16_ATOL)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv_prefill_decode_match_jax(jx, dtype):
    """Prefill, then decode steps: the WKV states and both token shifts
    carried in place (the shifts in bfloat16, as the JAX package stores
    them even in a float32 run)."""
    tokens = tokens_for(NAME)
    want, jcache = run_jax(jx, jx.smokes[NAME], 0, tokens, dtype)
    got, cache = run_port(SMOKES[NAME], 0, tokens, dtype)
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == "float32" else dict(atol=BF16_ATOL)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (B, 1, SMOKES[NAME].vocab)
        np.testing.assert_allclose(g, w, err_msg=f"step {i}", **tol)
    layers = cache["layers"]
    assert layers["tm_shift"].dtype == layers["cm_shift"].dtype == torch.bfloat16
    if dtype == "float32":
        # rtol: a bfloat16 shift may round the other way (2^-8 of it)
        for name in ("wkv", "tm_shift", "cm_shift"):
            np.testing.assert_allclose(_f32(layers[name]), _f32(jcache["layers"][name]),
                                       atol=1e-4, rtol=1e-2, err_msg=name)


def test_rwkv_decode_matches_teacher_forced_forward():
    """Each step's logits are the forward's at the same position, with the
    shift states kept in float32 (a bfloat16 shift rounds the decode's
    token shift where the forward's does not)."""
    cfg = SMOKES[NAME]
    tokens = tokens_for(NAME, seed=1)
    params = _f32_tree(steps.init_params(cfg, 1, "cpu"))
    cache = _f32_tree(steps.init_cache(cfg, B, PROMPT + STEPS, "cpu"))
    logits, same = steps.build_prefill_step(cfg)(params, {"tokens": tokens[:, :PROMPT]}, cache)
    assert same is cache and cache["layers"]["wkv"].abs().sum() > 0
    got = [logits]
    for i in range(STEPS):
        logits, _ = steps.build_decode_step(cfg)(
            params, cache, {"tokens": tokens[:, PROMPT + i:PROMPT + i + 1]}, PROMPT + i)
        got.append(logits)
    ref = steps.build_forward(cfg)(params, {"tokens": tokens})
    for i, g in enumerate(got):
        torch.testing.assert_close(g[:, 0], ref[:, PROMPT - 1 + i], atol=1e-4, rtol=1e-4)


def test_rwkv6_bf16_amplifies_a_rounding_nudge(monkeypatch):
    """Why ``chip_smoke.py`` holds full-width rwkv6-7b's bfloat16 logits to
    no rounding bound, and its float32 twin to one.  With random weights
    and all 32 layers, scaling every WKV6 output by 1 + 1e-6 -- about the
    kernel's own error against its plain version, and enough to flip a few
    bfloat16 roundings -- moves bfloat16 logits by more than four bfloat16
    ulps (the script's ``PLAIN_ULPS``) at ``d_model`` 1536, and float32
    logits by under 1e-3 of their magnitude.  The move grows with the
    width; at full width on the H100 the kernel and plain runs differ by 8
    ulps."""
    cfg = dataclasses.replace(ARCHS[NAME], d_model=1536, d_ff=512, vocab=512)
    assert cfg.n_layers == 32
    params = steps.init_params(cfg, 0, "cpu")
    batch = {"tokens": steps.make_batch(cfg, 16, 1, "train", 0)["tokens"]}
    forward = steps.build_forward(cfg)
    scan = rwkv6.wkv6

    def nudged(*args, **kw):
        y, sT = scan(*args, **kw)
        return y * (1 + 1e-6), sT
    moved = {}
    for dtype, p in (("bfloat16", params), ("float32", _f32_tree(params))):
        base = forward(p, batch).float()
        with monkeypatch.context() as m:
            m.setattr(rwkv6, "wkv6", nudged)
            moved[dtype] = (float((forward(p, batch).float() - base).abs().max()),
                            float(base.abs().max()))
    change, top = moved["bfloat16"]
    assert change > 4 * 2.0 ** (math.floor(math.log2(top)) - 7), moved
    change, top = moved["float32"]
    assert change < 1e-3 * top, moved


# -- snapshot and serving ---------------------------------------------------------


def test_rwkv_snapshot_bytes_match_jax(jx, tmp_path):
    gm_t = build_instance_snapshot(SMOKES[NAME], str(tmp_path / "t"), seed=3)
    gm_j = jx.build(jx.smokes[NAME], str(tmp_path / "j"), seed=3)
    assert filecmp.cmp(gm_t.manifest_path, gm_j.manifest_path, shallow=False)
    assert filecmp.cmp(gm_t.mem_path, gm_j.mem_path, shallow=False)


def test_rwkv_serving_matches_jax(jx, tmp_path):
    """Record, scale to zero and a REAP cold start in each package: the
    same fault trace, WS files and page store, and cold logits within the
    bfloat16 bound."""
    batch = {"tokens": tokens_for(NAME, seed=5)}
    logits = {}
    for pkg, orch in (("jax", jx.Orchestrator(str(tmp_path / "jax"), jx.ServeConfig())),
                      ("torch", Orchestrator(str(tmp_path / "torch"),
                                             ServeConfig(device="cpu")))):
        cfg = jx.smokes[NAME] if pkg == "jax" else SMOKES[NAME]
        try:
            orch.register("fn", cfg, warmup_batch=batch)
            _, rep = orch.invoke("fn", batch)
            assert rep.n_prefetched_pages == 0
            orch.scale_to_zero("fn")
            logits[pkg], rep = orch.invoke("fn", batch)
            assert rep.n_prefetched_pages > 0
        finally:
            orch.close()
    try:
        for rel in ("fn.trace.npy", "fn.ws", "fn.mem", ".pagestore/index.json",
                    ".pagestore/chunks.data"):
            assert filecmp.cmp(tmp_path / "jax" / rel, tmp_path / "torch" / rel,
                               shallow=False), rel
        np.testing.assert_allclose(logits["torch"].float().numpy(),
                                   np.asarray(logits["jax"], np.float32), atol=BF16_ATOL)
    finally:
        for mod in (jx.pagestore, pagestore):
            mod.reset_stores()
        jx.reap.WS_CACHE.clear()
        reap.WS_CACHE.clear()


# -- the kernel on the card -----------------------------------------------------

CUDA_WKV = [(*s, "float32", None) for s in WKV_SHAPES] + [
    (4, 1024, 64, 64, 32, "bfloat16", None),   # rwkv6-7b prefill
    (4, 1, 64, 64, 1, "bfloat16", None),       # rwkv6-7b decode step
    (2, 200, 4, 32, 32, "float32", None),      # ragged last tile
    (2, 96, 8, 16, 16, "bfloat16", None),
    (4, 1024, 64, 64, 32, "float32", None),    # rwkv6-7b f32 twin's prefill
    # L not a multiple of the kernel's chunk (16 steps), L = 1 a decode step
    *[(2, L, 4, 64, 32, "bfloat16", None) for L in (1, 15, 17, 200)],
    # strong decay: log decay uniform in [-30, -5] per step
    (2, 200, 4, 64, 32, "float32", (-30.0, -5.0)),
    (4, 1024, 64, 64, 32, "bfloat16", (-30.0, -5.0)),
    *[(2, L, 4, 32, 32, "float32", (-30.0, -5.0)) for L in (1, 17)],
]


@pytest.mark.cuda
@pytest.mark.parametrize("B_,L,H,D,chunk,dt,logw_range", CUDA_WKV)
def test_cuda_wkv6_matches_plain(cuda, B_, L, H, D, chunk, dt, logw_range):
    r, k, v, logw, u, s0 = (t.to(cuda) for t in
                            _t(wkv_inputs(B_, L, H, D, logw_range=logw_range)))
    r, k, v = (t.to(getattr(torch, dt)) for t in (r, k, v))
    n0 = LAUNCHES["wkv6_scan"]
    y, sT = wkv6(r, k, v, logw, u, s0, chunk=chunk)
    assert LAUNCHES["wkv6_scan"] == n0 + 1
    ry, rsT = wkv6_ref(r, k, v, logw, u, s0, chunk=chunk)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(sT).all())
    torch.testing.assert_close(y, ry, atol=WKV_ATOL, rtol=0)
    torch.testing.assert_close(sT, rsT, atol=WKV_ATOL, rtol=0)


@pytest.mark.cuda
def test_cuda_wkv6_reads_by_strides(cuda):
    """r, k, v and logw with the head axis permuted in memory, and slices
    of wider tensors, give the contiguous inputs' result bit for bit."""
    args = [t.to(cuda) for t in _t(wkv_inputs(2, 70, 4, 32))]
    want = wkv6(*args)
    perm = [a.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3) for a in args[:4]]
    wide = [torch.cat([a, a * 2], dim=-1)[..., :32] for a in args[:4]]
    for strided in (perm, wide):
        assert not any(a.is_contiguous() for a in strided)
        got = wkv6(*strided, *args[4:])
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=0, rtol=0)


@pytest.mark.cuda
def test_cuda_wkv6_rejects_what_the_kernel_does_not_take(cuda):
    r, k, v, logw, u, s0 = (t.to(cuda) for t in _t(wkv_inputs(1, 8, 2, 48)))
    with pytest.raises(ValueError, match="head dim"):
        wkv6(r, k, v, logw, u, s0)                                  # D = 48
    r, k, v, logw, u, s0 = (t.to(cuda) for t in _t(wkv_inputs(1, 8, 2, 16)))
    with pytest.raises(TypeError):
        wkv6(r.half(), k.half(), v.half(), logw, u, s0)
    with pytest.raises(TypeError):
        wkv6(r, k, v.bfloat16(), logw, u, s0)
    with pytest.raises(ValueError, match="contiguous"):
        wkv6(r.transpose(2, 3).contiguous().transpose(2, 3), k, v, logw, u, s0)


@pytest.mark.cuda
def test_cuda_rwkv_smoke_decode_runs_the_kernel(cuda):
    """rwkv6-7b SMOKE prefill and decode on the card: one launch a layer
    and call, logits within the bfloat16 bound of the plain versions."""
    cfg = SMOKES[NAME]
    tokens = torch.from_numpy(tokens_for(NAME)).to(cuda)
    params = steps.init_params(cfg, 0, cuda)
    out = {}
    for plain in (False, True):
        cache = steps.init_cache(cfg, B, PROMPT + STEPS, cuda)
        n0 = LAUNCHES["wkv6_scan"]
        logits, _ = steps.build_prefill_step(cfg)(params, {"tokens": tokens[:, :PROMPT]},
                                                  cache, plain=plain)
        got = [logits]
        for i in range(STEPS):
            logits, _ = steps.build_decode_step(cfg)(
                params, cache, {"tokens": tokens[:, PROMPT + i:PROMPT + i + 1]},
                PROMPT + i, plain=plain)
            got.append(logits)
        launches = LAUNCHES["wkv6_scan"] - n0
        assert launches == (0 if plain else cfg.n_layers * (1 + STEPS))
        out[plain] = torch.cat(got, 1).float()
    torch.testing.assert_close(out[False], out[True], atol=BF16_ATOL, rtol=0)
