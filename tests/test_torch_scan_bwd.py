"""The backward kernels of the two scans, B6 (``ssd_scan_bwd``) and B5
(``wkv6_scan_bwd``): their oracles on the CPU, their autograd wiring, and
the kernels on the card.

No Pallas kernel has a backward: the JAX model differentiates its plain
chunked scans (``repro.models.mamba2.ssd_chunked``,
``repro.models.rwkv6.wkv6_chunked``).  So the oracles
(``ssd_scan_bwd_ref``, ``wkv6_bwd_ref``, an explicit reverse pass) are
held to autograd of the port's plain scans and to ``jax.grad`` of the
JAX package's, in float32, at ragged lengths with a nonzero initial state
and a cotangent on the final state; so are the CPU mirrors of the
kernels' chunk-parallel decomposition (``ssd_chunked_bwd_ref``,
``wkv6_chunked_bwd_ref``, chunks of 32 steps).  The ``autograd.Function`` wiring runs
on the CPU with its launchers replaced by the plain versions.  Tests
marked ``cuda`` hold each kernel to its oracle at every head and state
dimension it is built for, and two calls bitwise equal; they skip without
a card.
"""
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from repro_torch.kernels.mamba2_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.mamba2_scan import (ssd_chunked_bwd_ref, ssd_scan,  # noqa: E402
                                             ssd_scan_bwd, ssd_scan_bwd_ref, ssd_scan_ref)
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan import (wkv6, wkv6_bwd_ref,  # noqa: E402
                                            wkv6_chunked_bwd_ref, wkv6_ref,
                                            wkv6_scan_bwd)

# The oracles against autograd of the chunked plain scans and against
# jax.grad, all in float32: the two sides sum in other orders (a step at a
# time against chunk products), so each gradient within REL of its largest
# magnitude.  Readings on the CPU: at most 8.5e-7 (SSD) and 8.9e-7
# (WKV6); the bound is about ten times that.
REL = 1e-5
STRONG_REL = 2e-4                      # test_plain_scan_grads_stay_finite_past_exp_overflow

SSD_SHAPES = [                         # (Bz, L, H, P, N, plain chunk)
    (2, 37, 3, 8, 4, 16),                # ragged: two full chunks and a part
    (1, 50, 2, 16, 8, 50),
    (2, 9, 2, 4, 4, 8),
]
WKV_SHAPES = [                         # (B, L, H, D, plain chunk)
    (2, 37, 3, 8, 16),
    (1, 50, 2, 16, 32),
    (2, 9, 2, 4, 8),
]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's chunked scans (skips where JAX is absent)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.models import mamba2 as jax_mamba2
    from repro.models import rwkv6 as jax_rwkv6
    return types.SimpleNamespace(jax=jax, jnp=jnp, mamba2=jax_mamba2, rwkv6=jax_rwkv6)


@pytest.fixture
def cuda():
    """The CUDA device, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def ssd_inputs(Bz, L, H, P, N, seed=0):
    """x, dt, A, B, C, h0 and the cotangents dy, dhT, float32 numpy (the
    value ranges of tests/test_kernels.py; h0 and dhT not 0)."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return (r(Bz, L, H, P), np.abs(r(Bz, L, H, scale=0.1)), -np.abs(r(H)),
            r(Bz, L, N, scale=0.3), r(Bz, L, N, scale=0.3), r(Bz, H, N, P, scale=0.1),
            r(Bz, L, H, P), r(Bz, H, N, P))


def wkv_inputs(B, L, H, D, seed=0):
    """r, k, v, logw, u, s0 and the cotangents dy, dsT, float32 numpy (the
    value ranges of tests/test_kernels.py; s0 and dsT not 0)."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return (r(B, L, H, D), r(B, L, H, D, scale=0.3), r(B, L, H, D),
            -np.abs(r(B, L, H, D, scale=0.5)) - 0.05, r(H, D, scale=0.2),
            r(B, H, D, D, scale=0.1), r(B, L, H, D), r(B, H, D, D))


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def assert_rel(got, want, rel, names):
    for name, g, w in zip(names, got, want):
        g, w = np.asarray(g, dtype=np.float64), np.asarray(w, dtype=np.float64)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        m = np.abs(w).max()
        assert np.abs(g - w).max() <= rel * m, (name, np.abs(g - w).max() / m)


def autograd_grads(fn, args, cotangents):
    """Gradients of sum(out * cotangent) over fn's outputs, by autograd."""
    leaves = [t.clone().requires_grad_(True) for t in args]
    outs = fn(*leaves)
    total = sum((o * c).sum() for o, c in zip(outs, cotangents))
    return torch.autograd.grad(total, leaves)


SSD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dh0")
WKV_NAMES = ("dr", "dk", "dv", "dlogw", "du", "ds0")


# -- the oracles ------------------------------------------------------------------


@pytest.mark.parametrize("Bz,L,H,P,N,chunk", SSD_SHAPES)
def test_ssd_bwd_ref_matches_autograd(Bz, L, H, P, N, chunk):
    *args, dy, dhT = _t(ssd_inputs(Bz, L, H, P, N))
    want = autograd_grads(lambda *a: ssd_scan_ref(*a, chunk=chunk), args, (dy, dhT))
    got = ssd_scan_bwd_ref(*args, dy, dhT)
    assert all(g.dtype == torch.float32 for g in got)
    assert_rel(got, want, REL, SSD_NAMES)


@pytest.mark.parametrize("Bz,L,H,P,N,chunk", SSD_SHAPES)
def test_ssd_bwd_ref_matches_jax(jx, Bz, L, H, P, N, chunk):
    """``jax.grad`` of the JAX model's ``ssd_chunked`` with D = 0, the
    scan the JAX Trainer differentiates."""
    jnp = jx.jnp
    x, dt, A, B, C, h0, dy, dhT = ssd_inputs(Bz, L, H, P, N, seed=L)
    D = np.zeros(H, np.float32)

    def f(*a):
        y, hT = jx.mamba2.ssd_chunked(a[0], a[1], a[2], a[3], a[4], jnp.asarray(D), a[5],
                                      chunk=chunk)
        return jnp.sum(y * jnp.asarray(dy)) + jnp.sum(hT * jnp.asarray(dhT))
    want = jx.jax.grad(f, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in (x, dt, A, B, C, h0)))
    got = ssd_scan_bwd_ref(*_t((x, dt, A, B, C, h0, dy, dhT)))
    assert_rel([g.numpy() for g in got], [np.asarray(w) for w in want], REL, SSD_NAMES)


@pytest.mark.parametrize("B,L,H,D,chunk", WKV_SHAPES)
def test_wkv6_bwd_ref_matches_autograd(B, L, H, D, chunk):
    *args, dy, dsT = _t(wkv_inputs(B, L, H, D))
    want = autograd_grads(lambda *a: wkv6_ref(*a, chunk=chunk), args, (dy, dsT))
    got = wkv6_bwd_ref(*args, dy, dsT)
    assert all(g.dtype == torch.float32 for g in got)
    assert_rel(got, want, REL, WKV_NAMES)


@pytest.mark.parametrize("B,L,H,D,chunk", WKV_SHAPES)
def test_wkv6_bwd_ref_matches_jax(jx, B, L, H, D, chunk):
    """``jax.grad`` of the JAX model's ``wkv6_chunked``."""
    jnp = jx.jnp
    r, k, v, logw, u, s0, dy, dsT = wkv_inputs(B, L, H, D, seed=L)

    def f(*a):
        y, sT = jx.rwkv6.wkv6_chunked(*a, chunk=chunk)
        return jnp.sum(y * jnp.asarray(dy)) + jnp.sum(sT * jnp.asarray(dsT))
    want = jx.jax.grad(f, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in (r, k, v, logw, u, s0)))
    got = wkv6_bwd_ref(*_t((r, k, v, logw, u, s0, dy, dsT)))
    assert_rel([g.numpy() for g in got], [np.asarray(w) for w in want], REL, WKV_NAMES)


# -- the mirrors of the kernels' chunk-parallel decomposition ------------------------
# Chunks of 32 steps, as the kernels': every SHAPES length is ragged
# against it.  Held to the per-step oracles and to jax.grad within REL
# (CPU readings: at most 4.2e-7 against the oracles).


@pytest.mark.parametrize("Bz,L,H,P,N,chunk", SSD_SHAPES)
def test_ssd_chunked_bwd_ref_matches_oracle(Bz, L, H, P, N, chunk):
    *args, dy, dhT = _t(ssd_inputs(Bz, L, H, P, N, seed=1))
    got = ssd_chunked_bwd_ref(*args, dy, dhT, chunk=32)
    assert all(g.dtype == torch.float32 for g in got)
    assert_rel(got, ssd_scan_bwd_ref(*args, dy, dhT), REL, SSD_NAMES)
    # without dhT the last chunk's gradient starts from zeros
    assert_rel(ssd_chunked_bwd_ref(*args, dy, chunk=32), ssd_scan_bwd_ref(*args, dy),
               REL, SSD_NAMES)


@pytest.mark.parametrize("Bz,L,H,P,N,chunk", SSD_SHAPES)
def test_ssd_chunked_bwd_ref_matches_jax(jx, Bz, L, H, P, N, chunk):
    jnp = jx.jnp
    x, dt, A, B, C, h0, dy, dhT = ssd_inputs(Bz, L, H, P, N, seed=L + 1)
    D = np.zeros(H, np.float32)

    def f(*a):
        y, hT = jx.mamba2.ssd_chunked(a[0], a[1], a[2], a[3], a[4], jnp.asarray(D), a[5],
                                      chunk=chunk)
        return jnp.sum(y * jnp.asarray(dy)) + jnp.sum(hT * jnp.asarray(dhT))
    want = jx.jax.grad(f, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in (x, dt, A, B, C, h0)))
    got = ssd_chunked_bwd_ref(*_t((x, dt, A, B, C, h0, dy, dhT)), chunk=32)
    assert_rel([g.numpy() for g in got], [np.asarray(w) for w in want], REL, SSD_NAMES)


@pytest.mark.parametrize("B,L,H,D,chunk", WKV_SHAPES)
def test_wkv6_chunked_bwd_ref_matches_oracle(B, L, H, D, chunk):
    *args, dy, dsT = _t(wkv_inputs(B, L, H, D, seed=1))
    got = wkv6_chunked_bwd_ref(*args, dy, dsT, chunk=32)
    assert all(g.dtype == torch.float32 for g in got)
    assert_rel(got, wkv6_bwd_ref(*args, dy, dsT), REL, WKV_NAMES)
    assert_rel(wkv6_chunked_bwd_ref(*args, dy, chunk=32), wkv6_bwd_ref(*args, dy),
               REL, WKV_NAMES)


@pytest.mark.parametrize("B,L,H,D,chunk", WKV_SHAPES)
def test_wkv6_chunked_bwd_ref_matches_jax(jx, B, L, H, D, chunk):
    jnp = jx.jnp
    r, k, v, logw, u, s0, dy, dsT = wkv_inputs(B, L, H, D, seed=L + 1)

    def f(*a):
        y, sT = jx.rwkv6.wkv6_chunked(*a, chunk=chunk)
        return jnp.sum(y * jnp.asarray(dy)) + jnp.sum(sT * jnp.asarray(dsT))
    want = jx.jax.grad(f, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in (r, k, v, logw, u, s0)))
    got = wkv6_chunked_bwd_ref(*_t((r, k, v, logw, u, s0, dy, dsT)), chunk=32)
    assert_rel([g.numpy() for g in got], [np.asarray(w) for w in want], REL, WKV_NAMES)


@pytest.mark.parametrize("chunk", [1, 3, 8, 64])
def test_bwd_refs_do_not_depend_on_their_chunk(chunk):
    """The recompute chunk changes where states are kept, not the sums."""
    *a, dy, dhT = _t(ssd_inputs(1, 21, 2, 4, 4, seed=3))
    for g, w in zip(ssd_scan_bwd_ref(*a, dy, dhT, chunk=chunk),
                    ssd_scan_bwd_ref(*a, dy, dhT, chunk=21)):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    *a, dy, dsT = _t(wkv_inputs(1, 21, 2, 4, seed=3))
    for g, w in zip(wkv6_bwd_ref(*a, dy, dsT, chunk=chunk),
                    wkv6_bwd_ref(*a, dy, dsT, chunk=21)):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


def test_plain_scan_grads_stay_finite_past_exp_overflow():
    """Strong decay, as full-width zamba2 reaches over a 128-step chunk: the
    chunk differences masked off above the diagonal overflow exp in float32.
    The plain scans mask them to -inf before exp, so their autograd
    gradients stay finite (a where() after exp gives 0 * inf = NaN) and
    equal the oracles'.  Under such decay dA and dlogw sum terms of both
    signs far larger than themselves: the CPU read 7.1e-5 (dA) and 5.4e-5
    (dlogw) of their largest magnitudes, so STRONG_REL is about three
    times that.  The chunk-parallel mirrors (the kernels' arithmetic, 32
    steps a chunk) take no difference of cumulative sums, so they are
    held to the oracles within REL (CPU readings 1.2e-6 and 2.3e-7)."""
    x, dt, A, B, C, h0, dy, dhT = _t(ssd_inputs(1, 64, 2, 4, 4))
    A = torch.full_like(A, -100.0)              # A dt sums to about -500 a chunk
    want = autograd_grads(lambda *a: ssd_scan_ref(*a, chunk=64), (x, dt, A, B, C, h0),
                          (dy, dhT))
    assert all(bool(torch.isfinite(w).all()) for w in want)
    oracle = ssd_scan_bwd_ref(x, dt, A, B, C, h0, dy, dhT)
    assert_rel(oracle, want, STRONG_REL, SSD_NAMES)
    mirror = ssd_chunked_bwd_ref(x, dt, A, B, C, h0, dy, dhT, chunk=32)
    assert all(bool(torch.isfinite(g).all()) for g in mirror)
    assert_rel(mirror, oracle, REL, SSD_NAMES)
    r, k, v, logw, u, s0, dy, dsT = _t(wkv_inputs(1, 32, 2, 4))
    logw = torch.from_numpy(np.random.default_rng(1).uniform(-30, -5, logw.shape)
                            .astype(np.float32))
    want = autograd_grads(lambda *a: wkv6_ref(*a, chunk=32), (r, k, v, logw, u, s0),
                          (dy, dsT))
    assert all(bool(torch.isfinite(w).all()) for w in want)
    oracle = wkv6_bwd_ref(r, k, v, logw, u, s0, dy, dsT)
    assert_rel(oracle, want, STRONG_REL, WKV_NAMES)
    mirror = wkv6_chunked_bwd_ref(r, k, v, logw, u, s0, dy, dsT, chunk=32)
    assert all(bool(torch.isfinite(g).all()) for g in mirror)
    assert_rel(mirror, oracle, REL, WKV_NAMES)


# -- the autograd wiring, with the launchers replaced by the plain versions ------------


@pytest.fixture
def plain_launchers(monkeypatch):
    """Both Functions' launchers replaced by the plain versions (so the
    wiring runs on CPU tensors); records each backward call's final-state
    cotangent."""
    seen = []

    def spy(ref):
        def call(*args):
            seen.append(args[7])
            return ref(*args)
        return call
    monkeypatch.setattr(ssd_ops, "_forward", ssd_scan_ref)
    monkeypatch.setattr(ssd_ops, "ssd_scan_bwd", spy(ssd_scan_bwd_ref))
    monkeypatch.setattr(wkv_ops, "_forward", wkv6_ref)
    monkeypatch.setattr(wkv_ops, "wkv6_scan_bwd", spy(wkv6_bwd_ref))
    return seen


@pytest.mark.parametrize("use_final", [False, True])
def test_ssd_function_wiring(plain_launchers, use_final):
    """Gradients through ``_SSDScan`` are autograd-of-plain's; the final
    state's cotangent is None where the loss ignores hT; h0 that does not
    require grad gets none; bfloat16 x gets a bfloat16 gradient."""
    x, dt, A, B, C, h0, dy, dhT = _t(ssd_inputs(2, 19, 2, 4, 4))
    for xdt in (torch.float32, torch.bfloat16):
        leaves = [t.clone().requires_grad_(True) for t in (x.to(xdt), dt, A, B, C)]
        y, hT = ssd_ops._SSDScan.apply(*leaves, h0)
        loss = (y * dy).sum() + ((hT * dhT).sum() if use_final else 0)
        grads = torch.autograd.grad(loss, leaves)
        assert (plain_launchers[-1] is not None) == use_final
        ref_leaves = [t.clone().requires_grad_(True) for t in (x.to(xdt), dt, A, B, C)]
        ry, rhT = ssd_scan_ref(*ref_leaves, h0)
        rloss = (ry * dy).sum() + ((rhT * dhT).sum() if use_final else 0)
        want = torch.autograd.grad(rloss, ref_leaves)
        assert grads[0].dtype == xdt and all(g.dtype == torch.float32 for g in grads[1:])
        assert_rel([g.float() for g in grads], [w.float() for w in want],
                   REL if xdt == torch.float32 else 2.0 ** -8, SSD_NAMES)
        leaf_h0 = h0.clone().requires_grad_(True)
        y, _ = ssd_ops._SSDScan.apply(x, dt, A, B, C, leaf_h0)
        (gh0,) = torch.autograd.grad((y * dy).sum(), [leaf_h0])
        assert gh0.dtype == torch.float32 and gh0.abs().sum() > 0


@pytest.mark.parametrize("use_final", [False, True])
def test_wkv6_function_wiring(plain_launchers, use_final):
    """As ``test_ssd_function_wiring``, for ``_WKV6Scan``: None for the
    final state's cotangent where sT is ignored, none for s0 that does not
    require grad, r/k/v gradients in r's dtype."""
    r, k, v, logw, u, s0, dy, dsT = _t(wkv_inputs(2, 19, 2, 4))
    for dt in (torch.float32, torch.bfloat16):
        leaves = [t.clone().requires_grad_(True) for t in
                  (r.to(dt), k.to(dt), v.to(dt), logw, u)]
        y, sT = wkv_ops._WKV6Scan.apply(*leaves, s0)
        loss = (y * dy).sum() + ((sT * dsT).sum() if use_final else 0)
        grads = torch.autograd.grad(loss, leaves)
        assert (plain_launchers[-1] is not None) == use_final
        ref_leaves = [t.clone().requires_grad_(True) for t in
                      (r.to(dt), k.to(dt), v.to(dt), logw, u)]
        ry, rsT = wkv6_ref(*ref_leaves, s0)
        rloss = (ry * dy).sum() + ((rsT * dsT).sum() if use_final else 0)
        want = torch.autograd.grad(rloss, ref_leaves)
        assert all(g.dtype == dt for g in grads[:3])
        assert all(g.dtype == torch.float32 for g in grads[3:])
        assert_rel([g.float() for g in grads], [w.float() for w in want],
                   REL if dt == torch.float32 else 2.0 ** -8, WKV_NAMES)
        leaf_s0 = s0.clone().requires_grad_(True)
        y, _ = wkv_ops._WKV6Scan.apply(r, k, v, logw, u, leaf_s0)
        (gs0,) = torch.autograd.grad((y * dy).sum(), [leaf_s0])
        assert gs0.dtype == torch.float32 and gs0.abs().sum() > 0


def test_cpu_wrappers_take_the_plain_graph(plain_launchers):
    """On CPU tensors the public wrappers run the plain chunked scans under
    autograd, never the Functions: no launcher is called."""
    x, dt, A, B, C, h0, dy, _ = _t(ssd_inputs(1, 12, 2, 4, 4))
    x.requires_grad_(True)
    y, _ = ssd_scan(x, dt, A, B, C, h0, chunk=4)
    (y * dy).sum().backward()
    r, k, v, logw, u, s0, dy, _ = _t(wkv_inputs(1, 12, 2, 4))
    r.requires_grad_(True)
    y, _ = wkv6(r, k, v, logw, u, s0, chunk=4)
    (y * dy).sum().backward()
    assert x.grad is not None and r.grad is not None and plain_launchers == []


# -- the kernels on the card -----------------------------------------------------------

# float32 kernel gradients against the oracle on the same inputs: the
# kernels chunk-parallel at split TF32, the oracle a step at a time, in
# other orders of summation: within the forwards' SSD_ATOL (5e-4) and
# wkv6's 1.2e-5 relative to each gradient's largest magnitude.  bfloat16
# dx / dr, dk, dv: rounded once from float32, four bfloat16 ulps at their
# largest magnitude, as chip_smoke's gate.  The last field: ROADMAP C4's
# strong decay (A = -100; log decays in [-30, -5]), where the gradients
# must also be finite.
CUDA_REL = {"ssd": 5e-4, "wkv": 1.2e-5}
CUDA_SSD_BWD = [(2, 37, 3, P, N, dt, False) for P in (32, 64, 128) for N in (16, 32, 64)
                for dt in ("float32", "bfloat16")] + [
    (4, 1024, 64, 64, 64, "bfloat16", False),    # zamba2-1.2b training
    (1, 1, 2, 64, 64, "float32", False),        # one step
    (1, 64, 2, 64, 16, "float32", True),        # ROADMAP C4
    (1, 64, 2, 64, 16, "bfloat16", True),
]
CUDA_WKV_BWD = [(2, 37, 3, D, dt, False) for D in (16, 32, 64)
                for dt in ("float32", "bfloat16")] + [
    (4, 1024, 64, 64, "bfloat16", False),        # rwkv6-7b training
    (1, 1, 2, 32, "float32", False),
    (1, 64, 2, 64, "float32", True),            # ROADMAP C4
    (1, 64, 2, 64, "bfloat16", True),
]


def _cuda_close(got, want, low, names, rel):
    for name, g, w in zip(names, got, want):
        w = w.float()
        m = float(w.abs().max())
        if g.dtype == torch.bfloat16:
            atol = 4 * 2.0 ** (np.floor(np.log2(m)) - 7) if m else 0.0
        else:
            atol = rel * max(m, 1e-30)
        err = float((g.float() - w).abs().max())
        assert err <= atol, (name, err, atol, low)


@pytest.mark.cuda
@pytest.mark.parametrize("Bz,L,H,P,N,dt,strong", CUDA_SSD_BWD)
def test_cuda_ssd_scan_bwd_matches_ref(cuda, Bz, L, H, P, N, dt, strong):
    x, dtv, A, B, C, h0, dy, dhT = (t.to(cuda) for t in _t(ssd_inputs(Bz, L, H, P, N)))
    x = x.to(getattr(torch, dt))
    if strong:
        A = torch.full_like(A, -100.0)
    reset_launches()
    got = ssd_scan_bwd(x, dtv, A, B, C, h0, dy, dhT)
    again = ssd_scan_bwd(x, dtv, A, B, C, h0, dy, dhT)
    assert LAUNCHES["ssd_scan_bwd"] == 2
    want = ssd_scan_bwd_ref(x, dtv, A, B, C, h0, dy, dhT)
    assert got[0].dtype == x.dtype
    assert all(bool(torch.isfinite(g).all()) for g in got)
    _cuda_close(got, want, dt, SSD_NAMES, CUDA_REL["ssd"])
    for a, b in zip(got, again):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,D,dt,strong", CUDA_WKV_BWD)
def test_cuda_wkv6_scan_bwd_matches_ref(cuda, B, L, H, D, dt, strong):
    r, k, v, logw, u, s0, dy, dsT = (t.to(cuda) for t in _t(wkv_inputs(B, L, H, D)))
    r, k, v = (t.to(getattr(torch, dt)) for t in (r, k, v))
    if strong:
        logw = torch.from_numpy(np.random.default_rng(1).uniform(-30, -5, logw.shape)
                                .astype(np.float32)).to(cuda)
    reset_launches()
    got = wkv6_scan_bwd(r, k, v, logw, u, s0, dy, dsT)
    again = wkv6_scan_bwd(r, k, v, logw, u, s0, dy, dsT)
    assert LAUNCHES["wkv6_scan_bwd"] == 2
    want = wkv6_bwd_ref(r, k, v, logw, u, s0, dy, dsT)
    assert all(g.dtype == r.dtype for g in got[:3])
    assert all(bool(torch.isfinite(g).all()) for g in got)
    _cuda_close(got, want, dt, WKV_NAMES, CUDA_REL["wkv"])
    for a, b in zip(got, again):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.cuda
def test_cuda_scans_under_autograd_launch_forward_and_backward_once(cuda):
    """Through the public wrappers with inputs that require grad: one
    forward and one backward launch each, gradients those of autograd
    through the plain scans; under no grad the forward alone."""
    x, dtv, A, B, C, h0, dy, _ = (t.to(cuda) for t in _t(ssd_inputs(2, 40, 2, 64, 16)))
    leaves = [t.clone().requires_grad_(True) for t in (x, dtv, A, B, C)]
    reset_launches()
    y, _ = ssd_scan(*leaves, h0)
    grads = torch.autograd.grad((y * dy).sum(), leaves)
    assert LAUNCHES["ssd_scan"] == 1 and LAUNCHES["ssd_scan_bwd"] == 1
    want = autograd_grads(lambda *a: ssd_scan_ref(*a, h0)[:1], (x, dtv, A, B, C), (dy,))
    _cuda_close(grads, want, "float32", SSD_NAMES, CUDA_REL["ssd"])
    r, k, v, logw, u, s0, dy, _ = (t.to(cuda) for t in _t(wkv_inputs(2, 40, 2, 32)))
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, logw, u)]
    reset_launches()
    y, _ = wkv6(*leaves, s0)
    grads = torch.autograd.grad((y * dy).sum(), leaves)
    assert LAUNCHES["wkv6_scan"] == 1 and LAUNCHES["wkv6_scan_bwd"] == 1
    want = autograd_grads(lambda *a: wkv6_ref(*a, s0)[:1], (r, k, v, logw, u), (dy,))
    _cuda_close(grads, want, "float32", WKV_NAMES, CUDA_REL["wkv"])
    reset_launches()
    with torch.no_grad():
        ssd_scan(x, dtv, A, B, C, h0)
        wkv6(r, k, v, logw, u, s0)
    assert LAUNCHES["ssd_scan_bwd"] == LAUNCHES["wkv6_scan_bwd"] == 0
