"""The forward's one-pass elementwise kernels (``kernels.elementwise``:
norms, RoPE on q and k, the SwiGLU gate) and ``nn.layers``' dispatch.

On the CPU: each plain version against the JAX package's
``repro.nn.layers`` at float32 and bfloat16; the wrappers' refusals (checked
before any launch, so a CPU host can raise them); the dispatch, which takes
the plain versions on the CPU, under ``plain=True`` and under autograd
(``LAUNCHES`` unchanged); and, with the kernels stood in for by their
plain versions plus a launch count, each family's launches per forward,
prefill and decode step against ``chip_smoke.eager_per_pass``.  The tests
marked ``cuda`` hold each kernel to its plain version on the card at
olmo-1b's, qwen2-7b's and zamba2-1.2b's widths (RoPE and SwiGLU bitwise,
the norms within one bfloat16 ulp) and count one full-width olmo-1b
forward's launches.  JAX is imported only by the tests that compare with
it.  On the H100: ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_elementwise.py``.
"""
import importlib.util
import os
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import ARCHS, SMOKES  # noqa: E402
from repro_torch.kernels import LAUNCHES, KernelError  # noqa: E402
from repro_torch.kernels.build import count_launch  # noqa: E402
from repro_torch.kernels.elementwise import (  # noqa: E402
    nonparam_ln, nonparam_ln_ref, rmsnorm, rmsnorm_ref, rope_qk, rope_ref, swiglu,
    swiglu_ref)
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import get_family  # noqa: E402
from repro_torch.nn import layers  # noqa: E402

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ELEMENTWISE = ("norm", "rope", "swiglu")


@pytest.fixture(scope="module")
def jl():
    """The JAX package's layers (skips where JAX is absent)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.nn import layers as jax_layers
    return types.SimpleNamespace(jax=jax, jnp=jnp, layers=jax_layers)


@pytest.fixture
def cuda():
    """The CUDA device, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def chip_smoke():
    """``chip_smoke.py`` as a module, on the CPU at a tiny prompt."""
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "chip_smoke.py")
    loader = importlib.util.spec_from_file_location("chip_smoke_elementwise", path)
    cs = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(cs)
    cs.DEVICE, cs.PROMPT, cs.DECODE_BATCH = "cpu", 8, 2
    return cs


def _draw(shape, seed, scale=1.0, shift=0.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _assert_matches_jax(got: torch.Tensor, want, dtype: str) -> None:
    """float32: to rounding; bfloat16: within one ulp of each element (the
    two frameworks sum a row in other orders)."""
    g = got.float().numpy()
    w = np.asarray(want.astype("float32"))
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    else:
        assert np.all(np.abs(g - w) <= 2.0 ** -7 * np.abs(w) + 1e-6)


# -- the plain versions against the JAX package ----------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", ["nonparam_ln", "rmsnorm", "rmsnorm_scale"])
def test_plain_norms_match_jax(jl, kind, dtype):
    x = _draw((2, 5, 64), 0, shift=0.5)         # a mean away from 0: the centred variance
    scale = _draw((64,), 1, 0.1, 1.0)
    xt = torch.from_numpy(x).to(DTYPES[dtype])
    xj = jl.jnp.asarray(x).astype(dtype)
    if kind == "nonparam_ln":
        got, want = nonparam_ln_ref(xt), jl.layers.apply_nonparam_ln(xj)
    elif kind == "rmsnorm":
        got, want = rmsnorm_ref(xt), jl.layers.apply_rmsnorm(None, xj)
    else:
        got = rmsnorm_ref(xt, torch.from_numpy(scale))
        want = jl.layers.apply_rmsnorm({"scale": jl.jnp.asarray(scale)}, xj)
    assert got.dtype == xt.dtype
    _assert_matches_jax(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("table", ["2d", "3d"])
@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2)])
def test_plain_rope_matches_jax(jl, H, KV, table, dtype):
    """``rope_ref`` on q and k (MHA and GQA), and ``nn.layers.apply_rope``
    on the CPU (both plain), against the JAX package's ``apply_rope``."""
    B, S, D = 2, 6, 32
    q, k = _draw((B, S, H, D), 2), _draw((B, S, KV, D), 3)
    pos = (np.arange(S) if table == "2d"
           else np.random.default_rng(4).integers(0, 500, (B, S)))
    cos, sin = layers.rope_table(torch.from_numpy(pos), D, 10_000.0)
    jcos, jsin = jl.layers.rope_table(jl.jnp.asarray(pos), D, 10_000.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    qt, kt = (torch.from_numpy(a).to(DTYPES[dtype]) for a in (q, k))
    pair = layers.apply_rope(qt, kt, cos, sin)
    for i, (a, t) in enumerate(((q, qt), (k, kt))):
        want = jl.layers.apply_rope(jl.jnp.asarray(a).astype(dtype), jcos, jsin)
        _assert_matches_jax(rope_ref(t, cos, sin), want, dtype)
        assert torch.equal(pair[i], rope_ref(t, cos, sin))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_swiglu_matches_jax(jl, dtype):
    """The JAX package's gate, ``silu(g.astype(f32)).astype(x.dtype) * u``."""
    g, u = _draw((2, 5, 96), 5, 3.0), _draw((2, 5, 96), 6)
    gt, ut = (torch.from_numpy(a).to(DTYPES[dtype]) for a in (g, u))
    gj, uj = (jl.jnp.asarray(a).astype(dtype) for a in (g, u))
    want = jl.jax.nn.silu(gj.astype(jl.jnp.float32)).astype(dtype) * uj
    got = swiglu_ref(gt, ut)
    assert got.dtype == gt.dtype
    _assert_matches_jax(got, want, dtype)


# -- the wrappers' refusals ------------------------------------------------------


def _bf16(*shape, offset=0):
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=torch.bfloat16)[offset:].view(*shape)


_TABLE = (torch.zeros(3, 16), torch.zeros(3, 16))
REFUSALS = {                 # name: (call, exception, message fragment)
    "norm on a CPU tensor": (lambda: rmsnorm(_bf16(4, 64)), ValueError, "CUDA"),
    "ln on a CPU tensor": (lambda: nonparam_ln(_bf16(4, 64)), ValueError, "CUDA"),
    "rope on CPU tensors": (lambda: rope_qk(_bf16(1, 3, 2, 32), _bf16(1, 3, 1, 32), *_TABLE),
                            ValueError, "CUDA"),
    "swiglu on CPU tensors": (lambda: swiglu(_bf16(2, 64), _bf16(2, 64)), ValueError, "CUDA"),
    "swiglu mixed dtypes": (lambda: swiglu(_bf16(2, 64), torch.zeros(2, 64)), TypeError,
                            "mixed"),
    "rope mixed dtypes": (lambda: rope_qk(_bf16(1, 3, 2, 32), torch.zeros(1, 3, 1, 32),
                                          *_TABLE), TypeError, "mixed"),
    "norm of float64": (lambda: rmsnorm(torch.zeros(2, 64, dtype=torch.float64)),
                        TypeError, "takes"),
    "rope odd head_dim": (lambda: rope_qk(_bf16(1, 3, 2, 31), _bf16(1, 3, 2, 31), *_TABLE),
                          ValueError, "head_dim"),
    "rope half head row not whole vectors": (
        lambda: rope_qk(_bf16(1, 3, 2, 24), _bf16(1, 3, 2, 24), torch.zeros(3, 12),
                        torch.zeros(3, 12)),
        ValueError, "head_dim"),
    "norm misaligned bf16": (lambda: rmsnorm(_bf16(4, 64, offset=1)), ValueError, "16-byte"),
    "rope misaligned bf16": (lambda: rope_qk(_bf16(1, 3, 2, 32, offset=3),
                                             _bf16(1, 3, 2, 32), *_TABLE),
                             ValueError, "16-byte"),
    "swiglu misaligned bf16": (lambda: swiglu(_bf16(2, 64, offset=2), _bf16(2, 64)),
                               ValueError, "16-byte"),
    "swiglu width of 12 bf16": (lambda: swiglu(_bf16(2, 12), _bf16(2, 12)), ValueError,
                                "16-byte"),
    "norm strided last dim": (lambda: rmsnorm(_bf16(64, 4).t()), ValueError, "contiguous"),
    "swiglu shapes differ": (lambda: swiglu(_bf16(2, 64), _bf16(4, 64)), ValueError, "differ"),
    "rope table shape": (lambda: rope_qk(_bf16(1, 3, 2, 32), _bf16(1, 3, 1, 32),
                                         torch.zeros(4, 16), torch.zeros(4, 16)),
                         ValueError, "cos/sin"),
    "rope table dtype": (lambda: rope_qk(_bf16(1, 3, 2, 32), _bf16(1, 3, 1, 32),
                                         _bf16(3, 16), _bf16(3, 16)), ValueError, "cos/sin"),
    "norm scale dtype": (lambda: rmsnorm(_bf16(2, 64), _bf16(64)), ValueError, "scale"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_wrappers_refuse(case):
    """Each wrapper raises on what its kernel does not take, before any
    launch: a CPU tensor, mixed or other dtypes, a head_dim whose halves
    are not whole 16-byte vectors, rows off 16-byte boundaries, a strided
    last dim, a bad table or scale."""
    call, exc, fragment = REFUSALS[case]
    before = dict(LAUNCHES)
    with pytest.raises(exc, match=fragment):
        call()
    assert LAUNCHES == before


# -- the dispatch ----------------------------------------------------------------


def _t(is_cuda=True, requires_grad=False):
    return types.SimpleNamespace(is_cuda=is_cuda, requires_grad=requires_grad)


def test_dispatch_predicate():
    """The kernels take CUDA inputs outside ``plain`` where no autograd
    graph is built; a None (no scale) does not count."""
    assert layers._fused(False, _t(), None)
    assert not layers._fused(True, _t())
    assert not layers._fused(False, _t(is_cuda=False))
    assert not layers._fused(False, _t(), _t(requires_grad=True))
    with torch.no_grad():
        assert layers._fused(False, _t(), _t(requires_grad=True))


def _refuse_kernels(monkeypatch):
    def launched(*args, **kw):
        raise AssertionError("a kernel wrapper was called")
    for name in ("rmsnorm", "nonparam_ln", "rope_qk", "swiglu"):
        monkeypatch.setattr(layers, name, launched)


@pytest.mark.parametrize("name", ["olmo-1b", "qwen2-7b"])
def test_dispatch_takes_plain_on_cpu_and_under_autograd(monkeypatch, name):
    """On the CPU every family forward and a loss with its gradients take
    the plain chains: no wrapper is called and ``LAUNCHES`` stays put, and
    the forward equals ``plain=True``'s bit for bit."""
    _refuse_kernels(monkeypatch)
    cfg = SMOKES[name]
    params = steps.init_params(cfg, 0, "cpu")
    batch = steps.make_batch(cfg, 16, 2, "prefill", 0)
    before = dict(LAUNCHES)
    fwd = get_family(cfg).forward
    assert torch.equal(fwd(cfg, params, batch), fwd(cfg, params, batch, plain=True))
    steps.loss_and_grads(cfg, params, steps.make_batch(cfg, 16, 2, "train", 0))
    assert LAUNCHES == before


@pytest.fixture
def counted_kernels(monkeypatch):
    """The dispatch as on the card, with each kernel stood in for by its
    plain version and a launch count: CPU tensors count as CUDA ones."""
    def fused(plain, *tensors):
        return not plain and not (torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors))

    def counted(name, fn):
        def call(*args, **kw):
            count_launch(name)
            return fn(*args, **kw)
        return call
    monkeypatch.setattr(layers, "_fused", fused)
    monkeypatch.setattr(layers, "rmsnorm", counted("norm", rmsnorm_ref))
    monkeypatch.setattr(layers, "nonparam_ln", counted("norm", nonparam_ln_ref))
    monkeypatch.setattr(layers, "rope_qk", counted(
        "rope", lambda q, k, c, s: (rope_ref(q, c, s), rope_ref(k, c, s))))
    monkeypatch.setattr(layers, "swiglu", counted("swiglu", swiglu_ref))


def _taken(before: dict) -> dict:
    return {k: LAUNCHES[k] - before[k] for k in ELEMENTWISE}


@pytest.mark.parametrize("name", sorted(SMOKES))
def test_launches_per_pass_match_chip_smoke(counted_kernels, chip_smoke, name):
    """Every family's forward, its prefill and one decode step launch
    exactly ``chip_smoke.eager_per_pass`` (a decode step runs no
    encoder); a ``plain=True`` forward and a loss with its gradients launch
    none; and the dispatch hands the kernels what the plain chains get, so
    the counted forward equals ``plain=True``'s bit for bit."""
    cfg = SMOKES[name]
    params = steps.init_params(cfg, 0, "cpu")
    prompt = chip_smoke.make_prompt(cfg)
    fwd = steps.build_forward(cfg)
    before = dict(LAUNCHES)
    with torch.no_grad():
        got = fwd(params, prompt)
    assert _taken(before) == chip_smoke.eager_per_pass(cfg)
    before = dict(LAUNCHES)
    assert torch.equal(got, fwd(params, prompt, plain=True))
    assert _taken(before) == dict.fromkeys(ELEMENTWISE, 0)
    with torch.no_grad():
        chip_smoke.generate(cfg, params, prompt, 1)
    per, step = chip_smoke.eager_per_pass(cfg), chip_smoke.eager_per_pass(cfg, encoder=False)
    assert _taken(before) == {k: per[k] + step[k] for k in ELEMENTWISE}
    before = dict(LAUNCHES)
    seq = 8 + (cfg.n_patches if cfg.family == "vlm" else 0)
    steps.loss_and_grads(cfg, params, steps.make_batch(cfg, seq, 2, "train", 0))
    assert _taken(before) == dict.fromkeys(ELEMENTWISE, 0)


def test_olmo_1b_counts_33_16_16(chip_smoke):
    """olmo-1b: two norms a layer and the head's, a RoPE launch and a
    SwiGLU gate a layer."""
    assert chip_smoke.eager_per_pass(ARCHS["olmo-1b"]) == {"norm": 33, "rope": 16,
                                                             "swiglu": 16}


# -- the kernels on the card -----------------------------------------------------

# (name, d_model, norm kind, H, KV, head_dim, d_ff) of the main paths' widths
WIDTHS = {
    "olmo-1b": (2048, "nonparam_ln", 16, 16, 128, 8192),
    "qwen2-7b": (3584, "rmsnorm", 28, 4, 128, 18944),
    "zamba2-1.2b": (2048, "rmsnorm", 32, 32, 64, 8192),
    "zamba2-1.2b/mamba": (4096, "rmsnorm", 32, 32, 64, 8192),   # its gated norm, d_inner
}
SEQS = {1: 4, 2048: 2}            # S -> B: a decode step, a long prompt


def _on(dev, shape, seed, dtype, scale=1.0, shift=0.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=dev) * scale + shift
    return x.to(DTYPES[dtype])


def _bf16_ulps_apart(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per element: whether ``got`` lies more than one bfloat16 ulp (at the
    larger magnitude of the pair) from ``want``, or past 2^-20 where the
    pair straddles zero (a centred value the two row sums place on either
    side of 0)."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return (g - w).abs() > torch.clamp(ulp, min=2.0 ** -20)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("S", list(SEQS))
@pytest.mark.parametrize("width", list(WIDTHS))
def test_cuda_norm_within_one_ulp(cuda, width, S, dtype, record_property):
    """Each norm of the main paths against its plain version: bfloat16
    within one ulp per element (the row sums' order differs), float32 to
    a few ulps; the count of elements that differ is recorded."""
    d, kind, *_ = WIDTHS[width]
    x = _on(cuda, (SEQS[S], S, d), 1, dtype, shift=0.5)
    if kind == "nonparam_ln":
        pairs = [(nonparam_ln(x), nonparam_ln_ref(x))]
    else:
        scale = _on(cuda, (d,), 2, "float32", 0.1, 1.0)
        pairs = [(rmsnorm(x, scale), rmsnorm_ref(x, scale)), (rmsnorm(x), rmsnorm_ref(x))]
    record_property("differing", [int((got != want).sum()) for got, want in pairs])
    for got, want in pairs:
        assert got.shape == x.shape and got.dtype == x.dtype
        if dtype == "bfloat16":
            assert not bool(_bf16_ulps_apart(got, want).any())
        else:
            torch.testing.assert_close(got, want, rtol=2e-6, atol=2e-6)


@pytest.mark.cuda
def test_cuda_norm_reads_strided_rows(cuda):
    """The prefill's last position (a (B, 1, d) view with the full row
    stride) and rows past a short table's end of a CTA."""
    x = _on(cuda, (3, 7, 2048), 3, "bfloat16")
    last = x[:, -1:, :]
    assert not last.is_contiguous()
    assert torch.equal(nonparam_ln(last), nonparam_ln(last.contiguous()))
    assert not bool(_bf16_ulps_apart(nonparam_ln(last), nonparam_ln_ref(last)).any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("S", list(SEQS))
@pytest.mark.parametrize("width", ["olmo-1b", "qwen2-7b", "zamba2-1.2b"])
def test_cuda_rope_bitwise(cuda, width, S, dtype):
    """q and k of one launch equal the plain version's bytes (GQA where the
    widths have it), with a decode step's table at a late position; q and
    k read through the strides of one fused (B, S, H + KV, D) buffer."""
    _, _, H, KV, D, _ = WIDTHS[width]
    B = SEQS[S]
    qk = _on(cuda, (B, S, H + KV, D), 4, dtype, 2.0)
    q, k = qk[:, :, :H], qk[:, :, H:]
    pos = torch.arange(S, device=cuda) + (1000 if S == 1 else 0)
    cos, sin = layers.rope_table(pos, D, 1_000_000.0)
    qo, ko = rope_qk(q, k, cos, sin)
    assert qo.is_contiguous() and ko.is_contiguous()
    assert torch.equal(qo, rope_ref(q, cos, sin))
    assert torch.equal(ko, rope_ref(k, cos, sin))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cuda_rope_batched_table_bitwise(cuda, dtype):
    """A (B, S, D/2) table (positions per sequence), GQA 16 / 4."""
    q, k = _on(cuda, (2, 33, 16, 128), 5, dtype), _on(cuda, (2, 33, 4, 128), 6, dtype)
    pos = torch.randint(0, 4096, (2, 33), device=cuda)
    cos, sin = layers.rope_table(pos, 128, 10_000.0)
    qo, ko = rope_qk(q, k, cos, sin)
    assert torch.equal(qo, rope_ref(q, cos, sin)) and torch.equal(ko, rope_ref(k, cos, sin))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("S", list(SEQS))
@pytest.mark.parametrize("d_ff", [8192, 18944, 1408])   # olmo/zamba2, qwen2-7b, deepseek's expert
def test_cuda_swiglu_bitwise(cuda, d_ff, S, dtype):
    g = _on(cuda, (SEQS[S], S, d_ff), 6, dtype, 4.0)
    u = _on(cuda, (SEQS[S], S, d_ff), 7, dtype)
    assert torch.equal(swiglu(g, u), swiglu_ref(g, u))


@pytest.mark.cuda
def test_cuda_one_olmo_forward_launches_33_16_16(cuda):
    """One full-width olmo-1b forward (its seed-0 parameters, one 64-token
    request) launches exactly 33 norms, 16 RoPE and 16
    SwiGLU kernels, beside 16 B3 launches, and its logits stay within a
    few bfloat16 ulps of the plain chains'."""
    cfg = ARCHS["olmo-1b"]
    params = steps.init_params(cfg, 0, cuda)
    batch = steps.make_batch(cfg, 64, 1, "prefill", 0)
    before = dict(LAUNCHES)
    with torch.no_grad():
        logits = get_family(cfg).forward(cfg, params, batch)
    got = {k: LAUNCHES[k] - before[k] for k in (*ELEMENTWISE, "flash_attention")}
    assert got == {"norm": 33, "rope": 16, "swiglu": 16, "flash_attention": 16}
    plain = get_family(cfg).forward(cfg, params, batch, plain=True).float()
    ulp = 2.0 ** (np.floor(np.log2(float(plain.abs().max()))) - 7)
    assert float((logits.float() - plain).abs().max()) <= 8 * ulp


@pytest.mark.cuda
def test_cuda_dispatch_plain_under_autograd(cuda):
    """With grad enabled and a parameter that requires grad, the norm takes
    the plain chain (autograd differentiates it) and launches nothing; the
    wrapper itself refuses such an input."""
    x = _on(cuda, (2, 4, 64), 8, "bfloat16")
    p = {"scale": torch.ones(64, device=cuda, requires_grad=True)}
    before = dict(LAUNCHES)
    y = layers.apply_rmsnorm(p, x)
    assert y.grad_fn is not None and LAUNCHES == before
    with pytest.raises(KernelError, match="no backward kernel"):
        rmsnorm(x, p["scale"])
    with torch.no_grad():
        layers.apply_rmsnorm(p, x)
    assert LAUNCHES["norm"] == before["norm"] + 1
