"""The port's KV-cache path against the JAX package's, and the
decode-attention kernel against its plain version.

Both packages get the same ``host_initialize`` parameters and the same
numpy tokens, then a prefill of 21 tokens and three decode steps through
``launch.steps``.  In float32 the logits agree to rounding (``atol = rtol =
1e-4``); in bfloat16 within ``BF16_ATOL`` (the bound of
``test_torch_model.py``, for the same reason).  The cache is bfloat16 in
both runs, as the config says, so float32 runs round K/V to bfloat16 in
both packages alike.

The plain decode attention is held to the JAX oracle and to the Pallas
kernel in interpret mode.  Tests marked ``cuda`` hold the CUDA kernel to
its plain version; they skip without a card.  JAX is imported inside the
fixture, so ``-m cuda`` runs where JAX is absent.
"""
import dataclasses
import math
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import SMOKES  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.kernels import LAUNCHES, gqa_decode  # noqa: E402
from repro_torch.kernels.decode_attention import gqa_decode_ref  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    KEYS_PER_TILE, MAX_SPLITS, n_splits, split_ranges)
from repro_torch.launch import steps  # noqa: E402
from repro_torch.nn import spec  # noqa: E402
from repro_torch.nn.layers import _quant_kv, chunked_attention  # noqa: E402

BF16_ATOL = 3e-2          # tests/test_torch_model.py
# int8 cache: per-(token, head) scales give each K/V element an error of at
# most amax/254; the two frameworks' float32 K/V differ in their last bits,
# which can move a value across a rounding boundary of the int8 grid.  So
# the caches may differ by one step of the grid and the logits by the
# effect of such steps: well under the bfloat16 bound.
INT8_LOGIT_ATOL = 1e-3
DECODE_SHAPES = [                     # tests/test_kernels.py:44-48 (B,S,H,KV,D)
    (2, 1024, 8, 2, 64),
    (1, 2048, 4, 4, 128),
    (3, 512, 16, 2, 80),
    # the configs' GQA widths at D = 128 and a short cache: G = 7 (qwen2-7b),
    # 5 (llama4-maverick), 4 (pixtral-12b, mistral-nemo-12b), 8 (qwen1.5-110b)
    (2, 96, 28, 4, 128),
    (2, 96, 40, 8, 128),
    (2, 96, 32, 8, 128),
    (2, 96, 64, 8, 128),
]
PROMPT, STEPS, B = 21, 3, 2


@pytest.fixture(scope="module")
def jx():
    """The JAX package's models, steps and decode kernels (skips where JAX
    is absent)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import SMOKES as JAX_SMOKES
    from repro.kernels.decode_attention.ops import gqa_decode as jax_gqa_decode
    from repro.kernels.decode_attention.ref import decode_attention_ref as jax_ref
    from repro.launch import steps as jax_steps
    from repro.nn import layers as jax_layers
    from repro.nn import spec as jax_spec
    return types.SimpleNamespace(jax=jax, jnp=jnp, smokes=JAX_SMOKES, steps=jax_steps,
                                 spec=jax_spec, layers=jax_layers,
                                 gqa_decode=jax_gqa_decode, ref=jax_ref)


@pytest.fixture
def cuda():
    """The CUDA device, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x, np.float32)


def _f32_tree(tree):
    return {k: _f32_tree(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


def run_jax(jx, cfg, seed, tokens, dtype):
    """Prefill + decode steps in the JAX package; logits per step."""
    jnp = jx.jnp
    cast = jnp.float32 if dtype == "float32" else None
    host = jx.spec.host_initialize(jx.steps.param_specs(cfg), seed=seed)
    params = jx.spec.map_leaves(lambda p, s: jnp.asarray(host[p]).astype(cast or s.dtype),
                                jx.steps.param_specs(cfg))
    cache = jx.steps.init_cache(cfg, B, PROMPT + STEPS)
    if dtype == "float32" and cfg.family == "hybrid":
        # the JAX scan returns the conv state in the activations' dtype
        cache["mamba"]["conv"] = cache["mamba"]["conv"].astype(jnp.float32)
    prefill = jx.jax.jit(jx.steps.build_prefill_step(cfg))
    decode = jx.jax.jit(jx.steps.build_decode_step(cfg))
    logits, cache = prefill(params, {"tokens": jnp.asarray(tokens[:, :PROMPT])}, cache)
    out = [_f32(logits)]
    for i in range(STEPS):
        step = {"tokens": jnp.asarray(tokens[:, PROMPT + i:PROMPT + i + 1])}
        logits, cache = decode(params, cache, step, PROMPT + i)
        out.append(_f32(logits))
    return out, cache


def run_port(cfg, seed, tokens, dtype, plain=False):
    """The same in the port, on the CPU, from the same parameter bytes."""
    params = steps.init_params(cfg, seed, "cpu")
    if dtype == "float32":
        params = _f32_tree(params)
    cache = steps.init_cache(cfg, B, PROMPT + STEPS, "cpu")
    if dtype == "float32" and cfg.family == "hybrid":
        cache["mamba"]["conv"] = cache["mamba"]["conv"].float()
    logits, cache = steps.build_prefill_step(cfg)(
        params, {"tokens": tokens[:, :PROMPT]}, cache, plain=plain)
    out = [_f32(logits)]
    decode = steps.build_decode_step(cfg)
    for i in range(STEPS):
        logits, same = decode(params, cache, {"tokens": tokens[:, PROMPT + i:PROMPT + i + 1]},
                              PROMPT + i, plain=plain)
        assert same is cache                       # written in place
        out.append(_f32(logits))
    return out, cache


def tokens_for(name, seed=0):
    return steps.make_batch(SMOKES[name], PROMPT + STEPS, B, "train", seed)["tokens"]


# -- the dense family ---------------------------------------------------------


@pytest.mark.parametrize("name", ["olmo-1b", "qwen2-7b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_decode_match_jax(jx, name, dtype):
    """olmo-1b: tied head, non-parametric LN, G = 1; qwen2-7b: GQA G = 2,
    the qkv bias and RMSNorm."""
    tokens = tokens_for(name)
    want, _ = run_jax(jx, jx.smokes[name], 0, tokens, dtype)
    got, _ = run_port(SMOKES[name], 0, tokens, dtype)
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == "float32" else dict(atol=BF16_ATOL)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (B, 1, SMOKES[name].vocab)
        np.testing.assert_allclose(g, w, err_msg=f"step {i}", **tol)


def test_decode_matches_teacher_forced_forward():
    """Each step's logits are the forward's at the same position (with a
    float32 cache, so that nothing is rounded on the way)."""
    cfg = dataclasses.replace(SMOKES["qwen2-7b"], kv_cache_dtype="float32")
    tokens = tokens_for("qwen2-7b", seed=1)
    got, _ = run_port(cfg, 1, tokens, "float32")
    ref = _f32(steps.build_forward(cfg)(_f32_tree(steps.init_params(cfg, 1, "cpu")),
                                        {"tokens": tokens}))
    for i, g in enumerate(got):
        np.testing.assert_allclose(g[:, 0], ref[:, PROMPT - 1 + i], atol=1e-4, rtol=1e-4)


def test_plain_run_matches_kernel_dispatch_on_cpu():
    """``plain=True`` (the kernels' plain versions) and the CPU dispatch
    (chunked attention) agree: the card's comparison is of like with like."""
    tokens = tokens_for("olmo-1b", seed=2)
    a, _ = run_port(SMOKES["olmo-1b"], 2, tokens, "float32")
    b, _ = run_port(SMOKES["olmo-1b"], 2, tokens, "float32", plain=True)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, atol=1e-5)


def test_quant_kv_bytes_match_jax(jx):
    """Same float32 input, same int8 bytes and scales; ties round to even."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 3, 32)).astype(np.float32)
    x[0, 0, 0, :4] = [127.0, 0.5, 1.5, -2.5]        # amax 127 -> scale 1: ties
    q, s = _quant_kv(torch.from_numpy(x))
    jq, js = jx.layers._quant_kv(jx.jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.numpy().tobytes() == np.asarray(jq).tobytes()
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    assert q[0, 0, 0, :4].tolist() == [127, 0, 2, -2]


def test_int8_cache_matches_jax(jx):
    name = "olmo-1b"
    cfg = dataclasses.replace(SMOKES[name], kv_cache_dtype="int8")
    jcfg = dataclasses.replace(jx.smokes[name], kv_cache_dtype="int8")
    tokens = tokens_for(name, seed=4)
    want, jcache = run_jax(jx, jcfg, 4, tokens, "float32")
    got, cache = run_port(cfg, 4, tokens, "float32")
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, atol=INT8_LOGIT_ATOL, err_msg=f"step {i}")
    kv = cache["kv"]
    assert kv["k"].dtype == torch.int8 and kv["k_scale"].dtype == torch.float32
    for n in ("k", "v"):
        q, sc = kv[n].numpy().astype(np.int32), kv[n + "_scale"].numpy()
        jq = np.asarray(jcache["kv"][n]).astype(np.int32)
        js = np.asarray(jcache["kv"][n + "_scale"])
        # layer 0 quantizes the same embeddings in both packages
        diff = np.abs(q[0] - jq[0])
        assert diff.max() <= 1 and (diff == 0).mean() > 0.99, n
        np.testing.assert_allclose(sc[0], js[0], rtol=1e-5)
        # later layers see the other package's (dequantized) attention: the
        # dequantized caches stay within two steps of the int8 grid
        step = np.maximum(sc, js)[..., None]
        assert (np.abs(q * sc[..., None] - jq * js[..., None]) <= 2 * step + 1e-7).all(), n


@pytest.mark.parametrize("name,kvd", [("olmo-1b", "bfloat16"), ("olmo-1b", "int8"),
                                      ("zamba2-1.2b", "bfloat16")])
def test_cache_specs_match_jax(jx, name, kvd):
    cfg = dataclasses.replace(SMOKES[name], kv_cache_dtype=kvd)
    jcfg = dataclasses.replace(jx.smokes[name], kv_cache_dtype=kvd)
    mine = {p: (s.shape, s.dtype) for p, s in spec.tree_paths(steps.cache_specs(cfg, 3, 40))}
    theirs = {p: (s.shape, str(np.dtype(s.dtype)))
              for p, s in jx.spec.tree_paths(jx.steps.cache_specs(jcfg, 3, 40))}
    assert mine == theirs


# -- decode attention: the plain version and the JAX package ------------------


def _decode_inputs(B_, S, H, KV, D, seed=42):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B_, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((B_, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B_, S, KV, D)).astype(np.float32)
    kv_len = rng.integers(1, S, B_).astype(np.int32)      # ragged
    return q, k, v, kv_len


@pytest.mark.parametrize("B_,S,H,KV,D", DECODE_SHAPES)
def test_plain_decode_attention_matches_jax(jx, B_, S, H, KV, D):
    jnp = jx.jnp
    q, k, v, kv_len = _decode_inputs(B_, S, H, KV, D)
    G = H // KV
    out = gqa_decode(*(torch.from_numpy(a) for a in (q, k, v, kv_len)))
    assert out.shape == (B_, 1, H, D) and out.dtype == torch.float32
    want_ref = np.asarray(jx.ref(jnp.asarray(q[:, 0].reshape(B_, KV, G, D)),
                                 jnp.moveaxis(jnp.asarray(k), 1, 2),
                                 jnp.moveaxis(jnp.asarray(v), 1, 2),
                                 jnp.asarray(kv_len))).reshape(B_, 1, H, D)
    want_pallas = np.asarray(jx.gqa_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           jnp.asarray(kv_len), bk=256))
    for want in (want_ref, want_pallas):
        np.testing.assert_allclose(out.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("B_,S,H,KV,D", DECODE_SHAPES)
def test_chunked_decode_matches_plain(B_, S, H, KV, D):
    """The model's CPU decode (one chunk, kv_len and causal mask at the
    query's position) against the kernel's plain version."""
    q, k, v, _ = _decode_inputs(B_, S, H, KV, D, seed=5)
    pos = S // 2
    q, k, v = (torch.from_numpy(a) for a in (q, k, v))
    got = chunked_attention(q, k, v, causal=True, q_offset=pos, kv_len=pos + 1, chunk=S)
    want = gqa_decode(q, k, v, torch.full((B_,), pos + 1, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)


def test_positions_past_kv_len_are_left_out():
    """Cache rows past kv_len take no part in the softmax, whatever they
    hold: zeros are not scored as 0."""
    q, k, v, kv_len = (torch.from_numpy(a) for a in _decode_inputs(2, 64, 4, 2, 32))
    base = gqa_decode(q, k, v, kv_len)
    for fill in (0.0, 1e4):
        k2, v2 = k.clone(), v.clone()
        for b in range(2):
            k2[b, kv_len[b]:] = fill
            v2[b, kv_len[b]:] = fill
        assert torch.equal(gqa_decode(q, k2, v2, kv_len), base)


@pytest.mark.parametrize("S", [1, 63, 64, 1056, 2080])
@pytest.mark.parametrize("B_,KV", [(4, 4), (4, 8), (4, 16), (1, 1)])
def test_split_ranges_cover_the_prefix_once(B_, KV, S):
    """The kernel's key ranges (``split_ranges`` mirrors its
    ``split_range``) at the wrapper's split count and others: for every
    valid length up to S, consecutive, each starting on a tile, within one
    tile of each other in length, together [0, kv_len) exactly once."""
    chosen = n_splits(B_, KV, S)
    assert 1 <= chosen <= min(-(-S // KEYS_PER_TILE), MAX_SPLITS)
    for n in {chosen, 1, 3, 17}:
        for kv_len in {0, 1, 63, 64, S}:
            if kv_len > S:
                continue
            ranges = split_ranges(kv_len, n)
            assert len(ranges) == n
            covered = []
            for lo, hi in ranges:
                assert lo <= hi and (lo == hi or lo % KEYS_PER_TILE == 0)
                covered.extend(range(lo, hi))
            assert covered == list(range(kv_len)), (n, kv_len)
            tiles = [-(-(hi - lo) // KEYS_PER_TILE) for lo, hi in ranges]
            assert max(tiles) - min(tiles) <= 1, (n, kv_len, tiles)


def test_gqa_decode_rejects_bad_input():
    q = torch.zeros(2, 1, 4, 32)
    k = torch.zeros(2, 16, 2, 32)
    with pytest.raises(ValueError):
        gqa_decode(q, torch.zeros(2, 16, 3, 32), torch.zeros(2, 16, 3, 32),
                   torch.ones(2, dtype=torch.int32))                       # H % KV
    with pytest.raises(ValueError):
        gqa_decode(q, k, k, torch.ones(3, dtype=torch.int32))              # kv_len
    with pytest.raises(TypeError):
        gqa_decode(q, k, k.double(), torch.ones(2, dtype=torch.int32))     # dtypes


# -- entry points ---------------------------------------------------------------


def test_entry_points_default_to_the_card():
    cfg = SMOKES["olmo-1b"]
    if torch.cuda.is_available():
        assert steps.device_of("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        steps.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        steps.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"embed/table": np.zeros((4, 2), np.float32)})


def test_serve_cli_runs_on_cpu(tmp_path, capsys):
    from repro_torch.core import pagestore, reap
    from repro_torch.launch import serve
    try:
        serve.main(["--arch", "olmo-1b", "--device", "cpu", "--seq", "16",
                    "--store", str(tmp_path / "store")])
    finally:
        pagestore.reset_stores()
        reap.WS_CACHE.clear()
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[1] for ln in lines] == ["[cold]", "[cold]", "[warm]"]
    assert "faults=0" in lines[2]


# -- the kernel on the card -----------------------------------------------------

CUDA_DECODE = [(*s, "float32", "float32") for s in DECODE_SHAPES] + [
    (4, 1056, 16, 16, 128, "bfloat16", "bfloat16"),   # olmo-1b decode
    (4, 1056, 32, 32, 64, "bfloat16", "bfloat16"),    # zamba2-1.2b decode
    (4, 1056, 28, 4, 128, "bfloat16", "bfloat16"),    # qwen2-7b decode (G = 7)
    (4, 2080, 32, 8, 128, "bfloat16", "bfloat16"),    # pixtral-12b decode (G = 4)
    # every head dim the bf16 kernel is built for: D = 64, 128, 80, and the
    # GQA widths G = 7, 5, 4, 8 at D = 128
    *[(*s, "bfloat16", "bfloat16") for s in DECODE_SHAPES],
    (2, 300, 8, 2, 32, "bfloat16", "bfloat16"),       # D = 32
    (2, 300, 8, 2, 64, "float32", "bfloat16"),        # float32 q, bf16 cache
]


@pytest.mark.cuda
@pytest.mark.parametrize("B_,S,H,KV,D,qdt,kvdt", CUDA_DECODE)
def test_cuda_decode_attention_matches_plain(cuda, B_, S, H, KV, D, qdt, kvdt):
    q, k, v, kv_len = _decode_inputs(B_, S, H, KV, D)
    q = torch.from_numpy(q).to(cuda, getattr(torch, qdt))
    k, v = (torch.from_numpy(a).to(cuda, getattr(torch, kvdt)) for a in (k, v))
    kv_len = torch.from_numpy(kv_len).to(cuda)
    n0 = LAUNCHES["decode_attention"]
    out = gqa_decode(q, k, v, kv_len)
    assert LAUNCHES["decode_attention"] == n0 + 1
    ref = gqa_decode_ref(q, k, v, kv_len)
    # a bfloat16 output (far below 1 after averaging 1056 random values):
    # four bfloat16 ulps at its largest magnitude, as chip_smoke.py holds it
    top = float(ref.float().abs().max())
    atol = 2e-5 if qdt == "float32" else 4 * 2.0 ** (math.floor(math.log2(top)) - 7)
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=atol)


@pytest.mark.cuda
def test_cuda_decode_reads_a_strided_cache(cuda):
    """A layer's slice of the stacked cache, and a cache with the KV-head
    axis permuted in memory, read through strides as the contiguous one."""
    q, k, v, kv_len = (torch.from_numpy(a).to(cuda) for a in _decode_inputs(2, 200, 8, 4, 64))
    want = gqa_decode(q, k, v, kv_len)
    stacked = torch.stack([k * 0, k, k * 2])
    k_perm = k.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    assert not k_perm.is_contiguous()
    for kk in (stacked[1], k_perm):
        torch.testing.assert_close(gqa_decode(q, kk, v, kv_len), want, atol=1e-6, rtol=0)


def _bf16_ulps(got, want) -> float:
    """The largest error in bfloat16 ulps at the output's largest magnitude."""
    top = float(want.float().abs().max())
    return float((got.float() - want.float()).abs().max()) / 2.0 ** (math.floor(math.log2(top)) - 7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_decode_valid_lengths(cuda, dtype):
    """kv_len 0 gives zeros (as the TPU kernel does); 1, a tile's 63 and 64,
    and S are held to the plain version, in one ragged batch at G = 7."""
    S = 300
    q, k, v, _ = (torch.from_numpy(a).to(cuda, getattr(torch, dtype))
                  for a in _decode_inputs(6, S, 28, 4, 128, seed=8))
    kv_len = torch.tensor([0, 1, 63, 64, S, 0], dtype=torch.int32, device=cuda)
    out = gqa_decode(q, k, v, kv_len)
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert torch.equal(out[5], torch.zeros_like(out[5]))
    ref = gqa_decode_ref(q[1:5], k[1:5], v[1:5], kv_len[1:5])
    if dtype == "float32":
        torch.testing.assert_close(out[1:5], ref, atol=2e-5, rtol=0)
    else:
        assert _bf16_ulps(out[1:5], ref) <= 4


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3, 7, 16])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_decode_any_split_count(cuda, monkeypatch, n, dtype):
    """Any split count merges to the plain version's result: one range
    (normalised in place), ranges left empty by short rows, and more
    ranges than tiles."""
    from repro_torch.kernels.decode_attention import ops
    q, k, v, kv_len = (torch.from_numpy(a).to(cuda) for a in _decode_inputs(3, 500, 28, 4, 128,
                                                                            seed=10))
    q, k, v = (t.to(getattr(torch, dtype)) for t in (q, k, v))
    kv_len[0] = 5
    monkeypatch.setattr(ops, "n_splits", lambda *_: n)
    out = gqa_decode(q, k, v, kv_len)
    ref = gqa_decode_ref(q, k, v, kv_len)
    if dtype == "float32":
        torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)
    else:
        assert _bf16_ulps(out, ref) <= 4


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 1056, 28, 4, 128), (2, 300, 8, 8, 64),
                                   (3, 200, 16, 2, 80)])
def test_cuda_decode_bf16_is_deterministic(cuda, shape):
    """No atomics and a fixed order of sums: two calls give the same bytes."""
    q, k, v, kv_len = (torch.from_numpy(a).to(cuda) for a in _decode_inputs(*shape, seed=9))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    a = gqa_decode(q, k, v, kv_len)
    b = gqa_decode(q, k, v, kv_len)
    assert torch.equal(a.view(torch.uint16), b.view(torch.uint16))


@pytest.mark.cuda
def test_cuda_decode_reads_a_strided_bf16_cache(cuda):
    """The bf16 route on a layer's slice of a stacked (L, B, S, KV, D) cache,
    as the model passes it, and on a cache whose KV-head axis is permuted
    in memory: the same bytes as on the contiguous cache."""
    q, k, v, kv_len = (torch.from_numpy(a).to(cuda) for a in _decode_inputs(2, 200, 28, 4, 128))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    want = gqa_decode(q, k, v, kv_len)
    stacked_k, stacked_v = torch.stack([k * 0, k, k * 2]), torch.stack([v * 2, v, v * 0])
    k_perm = k.permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
    assert not k_perm.is_contiguous()
    for kk, vv in ((stacked_k[1], stacked_v[1]), (k_perm, v)):
        assert torch.equal(gqa_decode(q, kk, vv, kv_len), want)


@pytest.mark.cuda
def test_cuda_decode_rejects_misaligned_bf16_cache(cuda):
    """The bf16 route copies 16-byte vectors: a cache that starts off a
    16-byte boundary, or whose rows do, is refused, not read misaligned."""
    q = torch.zeros(1, 1, 4, 64, dtype=torch.bfloat16, device=cuda)
    kv_len = torch.ones(1, dtype=torch.int32, device=cuda)
    base = torch.zeros(1 * 16 * 2 * 64 + 1, dtype=torch.bfloat16, device=cuda)
    k = base[1:].view(1, 16, 2, 64)
    assert k.is_contiguous() and k.data_ptr() % 16
    with pytest.raises(ValueError):
        gqa_decode(q, k, k, kv_len)
    wide = torch.zeros(1, 16, 2, 68, dtype=torch.bfloat16, device=cuda)[..., :64]
    assert wide.stride(2) % 8
    with pytest.raises(ValueError):
        gqa_decode(q, wide, wide, kv_len)
