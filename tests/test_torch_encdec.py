"""The port's VLM trunk and encoder-decoder family against the JAX
package's, and the two attention routes the encoder-decoder adds.

pixtral-12b SMOKE (the dense family with ``patch_embeds`` before the
tokens) and seamless-m4t-medium SMOKE (a bidirectional encoder over
``frames``, a decoder with cross-attention) run forward, prefill and
decode in both packages from the same ``host_initialize`` parameters and
the same numpy inputs (``launch.steps.make_batch``): float32 within
``atol = rtol = 1e-4``, bfloat16 within ``BF16_ATOL``.  The JAX
encoder-decoder casts its frames to ``cfg.dtype`` and scans with that
carry, so its float32 runs take a float32 config.  Snapshots, the inputs'
shapes and the frontend stubs' pages follow the JAX package's.  Tests
marked ``cuda`` hold the flash kernel without its causal mask, and the
decode kernel over a cross cache longer than its valid length, to their
plain versions; they skip without a card.
"""
import dataclasses
import filecmp
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import ARCHS, SMOKES  # noqa: E402
from repro_torch.core.arena import GuestMemoryFile, InstanceArena  # noqa: E402
from repro_torch.core.executor import run_invocation  # noqa: E402
from repro_torch.core.snapshot import build_instance_snapshot  # noqa: E402
from repro_torch.kernels import LAUNCHES, gqa_decode, mha  # noqa: E402
from repro_torch.kernels.decode_attention import gqa_decode_ref  # noqa: E402
from repro_torch.kernels.flash_attention import mha_ref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.nn import spec  # noqa: E402
from repro_torch.nn.layers import chunked_attention, cross_attention  # noqa: E402

from test_torch_decode import BF16_ATOL, _f32, _f32_tree  # noqa: E402

VLM, ENCDEC = "pixtral-12b", "seamless-m4t-medium"
TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=BF16_ATOL)}
B, TXT, STEPS = 2, 20, 3


@pytest.fixture(scope="module")
def jx():
    """The JAX package's steps, snapshot and executor (skips where JAX is
    absent)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import SMOKES as JAX_SMOKES
    from repro.core.arena import GuestMemoryFile as JaxGM
    from repro.core.arena import InstanceArena as JaxArena
    from repro.core.executor import run_invocation as jax_run_invocation
    from repro.core.snapshot import build_instance_snapshot as jax_build
    from repro.launch import steps as jax_steps
    from repro.nn import layers as jax_layers
    from repro.nn import spec as jax_spec
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, smokes=JAX_SMOKES, steps=jax_steps, spec=jax_spec,
        layers=jax_layers, build=jax_build, GM=JaxGM, Arena=JaxArena,
        run_invocation=jax_run_invocation)


@pytest.fixture
def cuda():
    """The CUDA device, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def configs(jx, name, dtype):
    """The port's and the JAX package's config: float32 runs of the
    encoder-decoder take ``dtype="float32"`` (its JAX encoder scans a carry
    of ``cfg.dtype``)."""
    cfg, jcfg = SMOKES[name], jx.smokes[name]
    if name == ENCDEC and dtype == "float32":
        cfg = dataclasses.replace(cfg, dtype="float32")
        jcfg = dataclasses.replace(jcfg, dtype=jx.jnp.float32)
    return cfg, jcfg


def prompt_for(cfg, seed=0):
    """A prompt of ``TXT`` tokens (after ``n_patches`` patches, or with
    ``TXT // frame_stride`` frames) and ``STEPS`` tokens to feed."""
    seq = TXT + (cfg.n_patches if cfg.family == "vlm" else 0)
    prompt = steps.make_batch(cfg, seq, B, "prefill", seed)
    fed = np.random.default_rng(seed + 1).integers(0, cfg.vocab, (B, STEPS), dtype=np.int32)
    return prompt, fed


def trunk_len(prompt):
    return prompt["tokens"].shape[1] + (prompt["patch_embeds"].shape[1]
                                        if "patch_embeds" in prompt else 0)


def run_jax(jx, jcfg, prompt, fed, dtype):
    jnp = jx.jnp
    host = jx.spec.host_initialize(jx.steps.param_specs(jcfg), seed=0)
    cast = jnp.float32 if dtype == "float32" else None
    params = jx.spec.map_leaves(lambda p, s: jnp.asarray(host[p]).astype(cast or s.dtype),
                                jx.steps.param_specs(jcfg))
    P = trunk_len(prompt)
    full = {**prompt, "tokens": np.concatenate([prompt["tokens"], fed], 1)}
    forward = np.asarray(jx.jax.jit(jx.steps.build_forward(jcfg))(
        params, {k: jnp.asarray(v) for k, v in full.items()}), np.float32)
    cache = jx.steps.init_cache(jcfg, B, P + STEPS)
    logits, cache = jx.jax.jit(jx.steps.build_prefill_step(jcfg))(
        params, {k: jnp.asarray(v) for k, v in prompt.items()}, cache)
    out = [_f32(logits)]
    decode = jx.jax.jit(jx.steps.build_decode_step(jcfg))
    for i in range(STEPS):
        logits, cache = decode(params, cache, {"tokens": jnp.asarray(fed[:, i:i + 1])}, P + i)
        out.append(_f32(logits))
    return forward, out


def run_port(cfg, prompt, fed, dtype):
    params = steps.init_params(cfg, 0, "cpu")
    if dtype == "float32":
        params = _f32_tree(params)
    P = trunk_len(prompt)
    full = {**prompt, "tokens": np.concatenate([prompt["tokens"], fed], 1)}
    forward = steps.build_forward(cfg)(params, full)
    assert forward.dtype == getattr(torch, dtype)
    cache = steps.init_cache(cfg, B, P + STEPS, "cpu")
    logits, cache = steps.build_prefill_step(cfg)(params, prompt, cache)
    out = [_f32(logits)]
    decode = steps.build_decode_step(cfg)
    for i in range(STEPS):
        logits, same = decode(params, cache, {"tokens": fed[:, i:i + 1]}, P + i)
        assert same is cache                       # written in place
        out.append(_f32(logits))
    return _f32(forward), out, cache


# -- the models against the JAX package ---------------------------------------------


@pytest.mark.parametrize("name", [VLM, ENCDEC])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_decode_match_jax(jx, name, dtype):
    """The forward over prompt and fed tokens, then prefill and decode
    steps: the VLM's decode positions continue after its patches and
    tokens; the encoder-decoder's cross cache is filled once, by prefill."""
    cfg, jcfg = configs(jx, name, dtype)
    prompt, fed = prompt_for(cfg)
    jfwd, jsteps = run_jax(jx, jcfg, prompt, fed, dtype)
    fwd, got, cache = run_port(cfg, prompt, fed, dtype)
    assert fwd.shape == jfwd.shape == (B, trunk_len(prompt) + STEPS, cfg.vocab)
    np.testing.assert_allclose(fwd, jfwd, **TOL[dtype])
    for i, (g, w) in enumerate(zip(got, jsteps)):
        np.testing.assert_allclose(g, w, err_msg=f"step {i}", **TOL[dtype])
    if name == ENCDEC:
        n_frames = prompt["frames"].shape[1]
        assert cache["enc_len"].dtype == torch.int32
        assert cache["enc_len"].tolist() == [n_frames] * B
        assert cache["cross_kv"]["k"][:, :, :n_frames].abs().sum() > 0
        assert not cache["cross_kv"]["k"][:, :, n_frames:].any()


@pytest.mark.parametrize("name,kvd", [(VLM, "bfloat16"), (ENCDEC, "bfloat16"),
                                      (ENCDEC, "int8")])
def test_cache_specs_match_jax(jx, name, kvd):
    """The encoder-decoder's cross cache stays in ``cfg.dtype`` beside an
    int8 self cache; ``enc_len`` is int32."""
    cfg = dataclasses.replace(SMOKES[name], kv_cache_dtype=kvd)
    jcfg = dataclasses.replace(jx.smokes[name], kv_cache_dtype=kvd)
    mine = {p: (s.shape, s.dtype) for p, s in spec.tree_paths(steps.cache_specs(cfg, 3, 40))}
    theirs = {p: (s.shape, str(np.dtype(s.dtype)))
              for p, s in jx.spec.tree_paths(jx.steps.cache_specs(jcfg, 3, 40))}
    assert mine == theirs


def test_batch_shapes_match_jax(jx):
    for name in ARCHS:
        for kind, seq in (("train", 40), ("prefill", 40), ("decode", 40), ("prefill", 3)):
            mine = steps.batch_shapes(SMOKES[name], seq, 2, kind)
            theirs = jx.steps.batch_shapes(jx.smokes[name], seq, 2, kind)
            assert {k: (s, d) for k, (s, d) in mine.items()} == \
                {k: (s, np.dtype(d).name) for k, (s, d) in theirs.items()}, (name, kind)


# -- snapshot and executor ----------------------------------------------------------


@pytest.mark.parametrize("name,modality", [(VLM, True), (VLM, False), (ENCDEC, True)])
def test_invocation_faults_like_jax(jx, tmp_path, name, modality):
    """Snapshots byte for byte; one invocation in each package: the same
    fault trace, with the frontend stub's pages when the request carries
    its modality and without them when it does not."""
    cfg, jcfg = SMOKES[name], jx.smokes[name]
    gm = build_instance_snapshot(cfg, str(tmp_path / "t"), seed=2)
    gm_j = jx.build(jcfg, str(tmp_path / "j"), seed=2)
    assert filecmp.cmp(gm.mem_path, gm_j.mem_path, shallow=False)
    assert filecmp.cmp(gm.manifest_path, gm_j.manifest_path, shallow=False)
    batch, _ = prompt_for(cfg, seed=4)
    if not modality:
        batch = {"tokens": batch["tokens"]}
    arena = InstanceArena(GuestMemoryFile.open(str(tmp_path / "t")))
    arena_j = jx.Arena(jx.GM.open(str(tmp_path / "j")))
    try:
        logits, _ = run_invocation(cfg, arena, batch, device="cpu")
        jlogits, _ = jx.run_invocation(jcfg, arena_j, batch)
        assert list(arena.stats.trace) == list(arena_j.stats.trace)
        stub = "vision/vit_stub" if name == VLM else "audio/frontend_stub"
        faulted = set(gm.layout.pages_of(stub)) & set(arena.stats.trace)
        assert faulted == (set(gm.layout.pages_of(stub)) if modality else set())
        np.testing.assert_allclose(_f32(logits), _f32(jlogits), atol=BF16_ATOL)
    finally:
        arena.close()
        arena_j.close()


# -- the attention routes -------------------------------------------------------------


def _qkv(B_, Sq, Skv, H, KV, D, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((B_, Sq, H, D), dtype=np.float32)),
            torch.from_numpy(rng.standard_normal((B_, Skv, KV, D), dtype=np.float32)),
            torch.from_numpy(rng.standard_normal((B_, Skv, KV, D), dtype=np.float32)))


def test_bidirectional_attention_matches_jax(jx):
    """No causal mask: the CPU route (chunked, several chunks), the
    kernel's plain version and the JAX package's chunked attention."""
    q, k, v = _qkv(2, 96, 96, 4, 2, 32)
    want = np.asarray(jx.layers.chunked_attention(
        *(jx.jnp.asarray(t.numpy()) for t in (q, k, v)), causal=False, chunk=32))
    for out in (chunked_attention(q, k, v, causal=False, chunk=32),
                mha(q, k, v, causal=False), mha_ref(q, k, v, causal=False)):
        np.testing.assert_allclose(out.numpy(), want, atol=2e-5)
    assert not np.allclose(mha(q, k, v).numpy(), want, atol=1e-2)   # causal differs


def test_cross_attention_over_a_cache(jx):
    """A decode step over a cross cache of 12 rows of which 9 are valid:
    the CPU route and the decode kernel's plain version agree with the JAX
    package's chunked attention, and rows past the valid length take no
    part, whatever they hold; a prompt (Sq != Skv) takes the same mask."""
    q, k, v = _qkv(2, 1, 12, 4, 4, 32, seed=3)
    enc_len = torch.full((2,), 9, dtype=torch.int32)
    want = np.asarray(jx.layers.chunked_attention(
        *(jx.jnp.asarray(t.numpy()) for t in (q, k, v)), causal=False,
        kv_len=jx.jnp.int32(9), chunk=64))
    base = cross_attention(q, k, v, enc_len, chunk=64)
    np.testing.assert_allclose(base.numpy(), want, atol=2e-5)
    np.testing.assert_allclose(gqa_decode_ref(q, k, v, enc_len).numpy(), want, atol=2e-5)
    k2, v2 = k.clone(), v.clone()
    k2[:, 9:], v2[:, 9:] = 1e4, -1e4
    assert torch.equal(cross_attention(q, k2, v2, enc_len, chunk=64), base)
    qp, _, _ = _qkv(2, 7, 12, 4, 4, 32, seed=4)
    wantp = np.asarray(jx.layers.chunked_attention(
        *(jx.jnp.asarray(t.numpy()) for t in (qp, k, v)), causal=False, kv_len=9, chunk=64))
    np.testing.assert_allclose(cross_attention(qp, k, v, 9, chunk=64).numpy(), wantp,
                               atol=2e-5)


# -- the kernels on the card ----------------------------------------------------------

CUDA_BIDIRECTIONAL = [                # (B, S, H, KV, D, dtype)
    (4, 128, 16, 16, 64, "bfloat16"),  # seamless-m4t-medium's encoder
    (4, 128, 16, 16, 64, "float32"),
    (2, 100, 8, 2, 128, "bfloat16"),   # ragged, GQA
    (2, 257, 4, 1, 80, "float32"),
    (1, 1, 4, 4, 32, "bfloat16"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B_,S,H,KV,D,dtype", CUDA_BIDIRECTIONAL)
def test_cuda_flash_bidirectional_matches_plain(cuda, B_, S, H, KV, D, dtype):
    """B3 without its causal mask: float32 within the kernel check's 2e-5,
    bfloat16 within four bf16 ulps at the output's largest magnitude."""
    q, k, v = (t.to(cuda, getattr(torch, dtype)) for t in _qkv(B_, S, S, H, KV, D, seed=S))
    n0 = LAUNCHES["flash_attention"]
    out = mha(q, k, v, causal=False)
    assert LAUNCHES["flash_attention"] == n0 + 1
    ref = mha_ref(q, k, v, causal=False).float()
    err = float((out.float() - ref).abs().max())
    if dtype == "float32":
        assert err <= 2e-5
    else:
        assert err <= 4 * 2.0 ** (np.floor(np.log2(float(ref.abs().max()))) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("qdt,kvdt", [("bfloat16", "bfloat16"), ("float32", "bfloat16")])
def test_cuda_cross_decode_matches_plain(cuda, qdt, kvdt):
    """B4 over seamless-m4t-medium's cross cache: 132 rows, 128 valid,
    through ``cross_attention``; rows past the valid length are ignored."""
    q, k, v = _qkv(4, 1, 132, 16, 16, 64, seed=5)
    q = q.to(cuda, getattr(torch, qdt))
    k, v = (t.to(cuda, getattr(torch, kvdt)) for t in (k, v))
    enc_len = torch.full((4,), 128, dtype=torch.int32, device=cuda)
    n0 = LAUNCHES["decode_attention"]
    out = cross_attention(q, k, v, enc_len)
    assert LAUNCHES["decode_attention"] == n0 + 1
    ref = gqa_decode_ref(q, k, v, enc_len).float()
    atol = 2e-5 if qdt == "float32" else 4 * 2.0 ** (
        np.floor(np.log2(float(ref.abs().max()))) - 7)
    assert float((out.float() - ref).abs().max()) <= atol
    k[:, 128:], v[:, 128:] = 100.0, -100.0
    assert torch.equal(cross_attention(q, k, v, enc_len), out)
