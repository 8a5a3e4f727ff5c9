"""The port's hybrid family (Mamba2 + a shared attention block, Zamba2)
against the JAX package's, and the SSD-scan kernel against its plain
version.

The plain SSD scan is held to the JAX oracle (``ssd_scan_ref``, a step by
step recurrence), to the Pallas kernel in interpret mode (``mamba2_ssd``)
and to the model's ``ssd_chunked``, at the shapes of
``tests/test_kernels.py``.  Zamba2 SMOKE runs forward, prefill and decode
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
from repro_torch.kernels import LAUNCHES, ssd_scan  # noqa: E402
from repro_torch.kernels.mamba2_scan import ssd_scan_ref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import mamba2  # noqa: E402
from repro_torch.serving import Orchestrator, ServeConfig  # noqa: E402

from test_torch_decode import BF16_ATOL, _f32_tree, run_jax, run_port, tokens_for  # noqa: E402

NAME = "zamba2-1.2b"
SSD_SHAPES = [                       # tests/test_kernels.py:68-72 (Bz,L,H,P,N,chunk)
    (2, 256, 4, 64, 64, 64),
    (1, 512, 2, 128, 32, 128),
    (2, 128, 8, 32, 16, 32),
]
SSD_ATOL = 5e-4                      # tests/test_kernels.py:91


@pytest.fixture(scope="module")
def jx():
    """The JAX package's hybrid model, steps and SSD kernels (skips where
    JAX is absent)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import SMOKES as JAX_SMOKES
    from repro.core import pagestore as jax_pagestore
    from repro.core import reap as jax_reap
    from repro.core.snapshot import build_instance_snapshot as jax_build
    from repro.kernels.mamba2_scan.ops import mamba2_ssd
    from repro.kernels.mamba2_scan.ref import ssd_scan_ref as jax_ref
    from repro.launch import steps as jax_steps
    from repro.models import mamba2 as jax_mamba2
    from repro.nn import spec as jax_spec
    from repro.serving import Orchestrator as JaxOrchestrator
    from repro.serving import ServeConfig as JaxServeConfig
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, smokes=JAX_SMOKES, steps=jax_steps, spec=jax_spec,
        mamba2=jax_mamba2, ssd=mamba2_ssd, ref=jax_ref, build=jax_build,
        pagestore=jax_pagestore, reap=jax_reap, Orchestrator=JaxOrchestrator,
        ServeConfig=JaxServeConfig)


@pytest.fixture
def cuda():
    """The CUDA device, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def ssd_inputs(Bz, L, H, P, N, seed=42, decay_sum=None):
    """x, dt, A, B, C, D, h0 as float32 numpy arrays (the value ranges of
    tests/test_kernels.py).  With ``decay_sum``, each head's A is scaled so
    that A dt sums to it over batch row 0's first 128 steps (strong decay)."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    x, dt, A = r(Bz, L, H, P), np.abs(r(Bz, L, H, scale=0.1)), -np.abs(r(H))
    if decay_sum is not None:
        A = (decay_sum / dt[0, :128].sum(0)).astype(np.float32)
    return (x, dt, A, r(Bz, L, N, scale=0.3), r(Bz, L, N, scale=0.3), r(H),
            r(Bz, H, N, P, scale=0.1))


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


# -- the SSD scan: plain version against the JAX package ----------------------


@pytest.mark.parametrize("Bz,L,H,P,N,chunk", SSD_SHAPES)
def test_plain_ssd_scan_matches_jax(jx, Bz, L, H, P, N, chunk):
    jnp = jx.jnp
    x, dt, A, B, C, D, h0 = ssd_inputs(Bz, L, H, P, N)
    y, hT = ssd_scan(*_t((x, dt, A, B, C, h0)), chunk=chunk)
    assert y.dtype == hT.dtype == torch.float32
    y = y.numpy() + x * D[None, None, :, None]
    jy, jhT = jx.ssd(*(jnp.asarray(a) for a in (x, dt, A, B, C, D, h0)), chunk=chunk)
    # the step-by-step oracle, in the kernel's flattened (b*h) layout
    flat = Bz * H
    ry, rhT = jx.ref(jnp.asarray(x.transpose(0, 2, 1, 3).reshape(flat, L, P)),
                     jnp.asarray(dt.transpose(0, 2, 1).reshape(flat, L)),
                     jnp.asarray(np.tile(A, Bz)),
                     jnp.asarray(np.broadcast_to(B[:, None], (Bz, H, L, N)).reshape(flat, L, N)),
                     jnp.asarray(np.broadcast_to(C[:, None], (Bz, H, L, N)).reshape(flat, L, N)),
                     jnp.asarray(h0.reshape(flat, N, P)))
    ry = np.asarray(ry).reshape(Bz, H, L, P).transpose(0, 2, 1, 3) + x * D[None, None, :, None]
    for wy, whT in ((np.asarray(jy), np.asarray(jhT)),
                    (ry, np.asarray(rhT).reshape(Bz, H, N, P))):
        np.testing.assert_allclose(y, wy, atol=SSD_ATOL)
        np.testing.assert_allclose(hT.numpy(), whT, atol=SSD_ATOL)


@pytest.mark.parametrize("L", [1, 24, 200])
def test_ssd_chunked_matches_jax(jx, L):
    """The model's scan at decode (L = 1), one ragged chunk and a padded
    second chunk, with the model's chunk rule."""
    jnp = jx.jnp
    x, dt, A, B, C, D, h0 = ssd_inputs(2, L, 4, 16, 8, seed=L)
    chunk = min(128, max(8, L))
    y, hT = mamba2.ssd_chunked(*_t((x, dt, A, B, C, D, h0)), chunk=chunk)
    jy, jhT = jx.mamba2.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, B, C, D, h0)),
                                    chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(hT.numpy(), np.asarray(jhT), atol=1e-5, rtol=1e-5)


def test_ssd_ref_is_chunk_invariant():
    """Chunk sizes that divide L, that leave a ragged chunk, and L itself."""
    arrs = _t(ssd_inputs(1, 50, 2, 8, 4, seed=7))
    x, dt, A, B, C, _, h0 = arrs
    y1, s1 = ssd_scan_ref(x, dt, A, B, C, h0, chunk=50)
    for chunk in (1, 7, 25):
        y2, s2 = ssd_scan_ref(x, dt, A, B, C, h0, chunk=chunk)
        torch.testing.assert_close(y2, y1, atol=2e-5, rtol=1e-5)
        torch.testing.assert_close(s2, s1, atol=2e-5, rtol=1e-5)


def test_ssd_scan_rejects_bad_input():
    x, dt, A, B, C, _, h0 = _t(ssd_inputs(1, 8, 2, 4, 4))
    with pytest.raises(ValueError):
        ssd_scan(x, dt[:, :4], A, B, C, h0)                 # L mismatch
    with pytest.raises(ValueError):
        ssd_scan(x, dt, A, B, C[..., :3], h0)                # N mismatch


# -- the Zamba2 model against the JAX package -----------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zamba_forward_matches_jax(jx, dtype):
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
def test_zamba_prefill_decode_match_jax(jx, dtype):
    """Prefill, then decode steps: Mamba states and the shared block's KV
    caches, one per application, carried in place."""
    tokens = tokens_for(NAME)
    want, jcache = run_jax(jx, jx.smokes[NAME], 0, tokens, dtype)
    got, cache = run_port(SMOKES[NAME], 0, tokens, dtype)
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == "float32" else dict(atol=BF16_ATOL)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, err_msg=f"step {i}", **tol)
    if dtype == "float32":
        np.testing.assert_allclose(cache["mamba"]["ssm"].numpy(),
                                   np.asarray(jcache["mamba"]["ssm"]), atol=1e-4, rtol=1e-4)


def test_shared_block_has_one_cache_per_application():
    cfg = SMOKES[NAME]
    cache = steps.init_cache(cfg, 2, 24, "cpu")
    groups = cfg.n_layers // cfg.attn_every
    assert cache["attn_kv"]["k"].shape[0] == groups
    assert cache["mamba"]["ssm"].shape[:2] == (groups, cfg.attn_every)
    params = steps.init_params(cfg, 0, "cpu")
    assert "lm_head" in params and "attn" in params["shared_attn"]
    steps.build_prefill_step(cfg)(params, {"tokens": tokens_for(NAME)[:, :5]}, cache)
    for g in range(groups):            # every application wrote its own cache
        assert cache["attn_kv"]["k"][g, :, :5].abs().sum() > 0
        assert not cache["attn_kv"]["k"][g, :, 5:].any()


def test_zamba2_bf16_amplifies_a_rounding_nudge(monkeypatch):
    """Why ``chip_smoke.py`` holds full-width zamba2's bfloat16 logits to no
    rounding bound, and its float32 twin to one.  With random weights and
    all 38 Mamba2 layers (d_model 512 here), scaling every SSD output by
    1 + 1e-6 -- less than any kernel's error, but enough to flip a few
    bfloat16 roundings -- moves bfloat16 logits by more than four bfloat16
    ulps (the script's ``PLAIN_ULPS``), and float32 logits by under 1e-3 of
    their magnitude."""
    cfg = dataclasses.replace(ARCHS[NAME], d_model=512, n_heads=8, n_kv_heads=8,
                              d_ff=2048, vocab=512)
    assert cfg.n_layers == 38
    params = steps.init_params(cfg, 0, "cpu")
    batch = {"tokens": steps.make_batch(cfg, 8, 1, "train", 0)["tokens"]}
    forward = steps.build_forward(cfg)
    scan = mamba2.ssd_scan

    def nudged(*args, **kw):
        y, hT = scan(*args, **kw)
        return y * (1 + 1e-6), hT
    moved = {}
    for dtype, p in (("bfloat16", params), ("float32", _f32_tree(params))):
        base = forward(p, batch).float()
        with monkeypatch.context() as m:
            m.setattr(mamba2, "ssd_scan", nudged)
            moved[dtype] = (float((forward(p, batch).float() - base).abs().max()),
                            float(base.abs().max()))
    change, top = moved["bfloat16"]
    assert change > 4 * 2.0 ** (math.floor(math.log2(top)) - 7), moved
    change, top = moved["float32"]
    assert change < 1e-3 * top, moved


# -- snapshot and serving ---------------------------------------------------------


def test_zamba_snapshot_bytes_match_jax(jx, tmp_path):
    gm_t = build_instance_snapshot(SMOKES[NAME], str(tmp_path / "t"), seed=3)
    gm_j = jx.build(jx.smokes[NAME], str(tmp_path / "j"), seed=3)
    assert filecmp.cmp(gm_t.manifest_path, gm_j.manifest_path, shallow=False)
    assert filecmp.cmp(gm_t.mem_path, gm_j.mem_path, shallow=False)


def test_zamba_serving_matches_jax(jx, tmp_path):
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

CUDA_SSD = [(*s, "float32", None) for s in SSD_SHAPES] + [
    (4, 1024, 64, 64, 64, 128, "bfloat16", None),   # zamba2-1.2b prefill
    (4, 1, 64, 64, 64, 1, "bfloat16", None),        # zamba2-1.2b decode step
    (2, 200, 4, 32, 16, 128, "float32", None),      # ragged last chunk
    (4, 1024, 64, 64, 64, 128, "float32", None),    # zamba2-1.2b f32 twin's prefill
    # L not a multiple of the kernel's chunk (32 steps), L = 1 a decode step
    *[(2, L, 4, 64, 64, 128, "bfloat16", None) for L in (1, 15, 17, 200)],
    # strong decay: A dt sums to -200 over 128 steps
    (2, 256, 4, 64, 64, 128, "float32", -200.0),
    (4, 1024, 64, 64, 64, 128, "bfloat16", -200.0),
    *[(2, L, 4, 32, 16, 128, "float32", -200.0) for L in (1, 17)],
]


@pytest.mark.cuda
@pytest.mark.parametrize("Bz,L,H,P,N,chunk,xdt,decay_sum", CUDA_SSD)
def test_cuda_ssd_scan_matches_plain(cuda, Bz, L, H, P, N, chunk, xdt, decay_sum):
    x, dt, A, B, C, _, h0 = (t.to(cuda) for t in
                             _t(ssd_inputs(Bz, L, H, P, N, decay_sum=decay_sum)))
    x = x.to(getattr(torch, xdt))
    n0 = LAUNCHES["ssd_scan"]
    y, hT = ssd_scan(x, dt, A, B, C, h0, chunk=chunk)
    assert LAUNCHES["ssd_scan"] == n0 + 1
    ry, rhT = ssd_scan_ref(x, dt, A, B, C, h0, chunk=chunk)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(hT).all())
    torch.testing.assert_close(y, ry, atol=SSD_ATOL, rtol=0)
    torch.testing.assert_close(hT, rhT, atol=SSD_ATOL, rtol=0)


@pytest.mark.cuda
def test_cuda_ssd_scan_reads_x_by_strides(cuda):
    x, dt, A, B, C, _, h0 = (t.to(cuda) for t in _t(ssd_inputs(2, 96, 4, 32, 16)))
    want = ssd_scan(x, dt, A, B, C, h0, chunk=32)
    x_perm = x.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    assert not x_perm.is_contiguous()
    got = ssd_scan(x_perm, dt, A, B, C, h0, chunk=32)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
