"""The port's kernels against the JAX package's Pallas kernels and oracles.

On the CPU the wrappers run their plain versions, which are held byte for
byte (gather/scatter) or within the dtype's tolerance (attention) to
``repro.kernels`` in interpret mode and to its ``ref.py`` oracles.  The
tests marked ``cuda`` hold each CUDA kernel to its plain version on the
card; they skip on a host without one.  JAX is imported only by the tests
that compare with it, so the file also runs where JAX is absent.  On the
H100: ``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels.py``.
"""
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core.restore import default_fuse_engine, fuse_ws_block  # noqa: E402
from repro_torch.kernels import gather_pages, mha, scatter_pages  # noqa: E402
from repro_torch.kernels.build import aligned16  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_ref, mha_ref  # noqa: E402
from repro_torch.kernels.page_gather import page_gather_ref, page_scatter_ref  # noqa: E402
from repro_torch.nn.layers import chunked_attention  # noqa: E402

FLASH_SHAPES = [                       # tests/test_kernels.py:19-24
    (2, 256, 4, 2, 64, "float32"),
    (1, 128, 8, 8, 128, "float32"),
    (2, 384, 6, 2, 80, "float32"),
    (1, 256, 4, 1, 64, "bfloat16"),
    # bf16 at olmo-1b's head dim with GQA, against the Pallas kernel, which
    # rounds P to bf16 before P V
    (1, 128, 8, 2, 128, "bfloat16"),
]
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py:35


@pytest.fixture(scope="module")
def jx():
    """The JAX package's kernels and oracles (skips where JAX is absent)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core.restore import fuse_ws_block
    from repro.kernels import gather_pages, mha, scatter_pages
    from repro.kernels.flash_attention.ref import flash_attention_ref
    from repro.kernels.page_gather.ref import page_gather_ref, page_scatter_ref
    return types.SimpleNamespace(
        jnp=jnp, fuse=fuse_ws_block, gather=gather_pages, scatter=scatter_pages,
        mha=mha, flash_ref=flash_attention_ref, gather_ref=page_gather_ref,
        scatter_ref=page_scatter_ref)


@pytest.fixture
def cuda():
    """The CUDA device, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _rows(n, width, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, (n, width), dtype=np.uint8)
    return rng.standard_normal((n, width)).astype(dtype)


# -- page gather / scatter ---------------------------------------------------


@pytest.mark.parametrize("width,dtype", [(4096, np.uint8), (100, np.float32)])
def test_plain_gather_matches_jax(jx, width, dtype):
    jnp = jx.jnp
    table = _rows(24, width, dtype, 1)
    idx = np.random.default_rng(2).integers(0, 24, 17).astype(np.int64)
    out = gather_pages(torch.from_numpy(table), torch.from_numpy(idx)).numpy()
    ref = page_gather_ref(torch.from_numpy(table), torch.from_numpy(idx)).numpy()
    jk = np.asarray(jx.gather(jnp.asarray(table), jnp.asarray(idx.astype(np.int32)),
                              interpret=True))
    jr = np.asarray(jx.gather_ref(jnp.asarray(table), jnp.asarray(idx)))
    for other in (ref, jk, jr):
        assert other.tobytes() == out.tobytes()


@pytest.mark.parametrize("width,dtype", [(4096, np.uint8), (100, np.float32)])
def test_plain_scatter_matches_jax(jx, width, dtype):
    jnp = jx.jnp
    ws = _rows(11, width, dtype, 3)
    idx = np.random.default_rng(4).permutation(20)[:11].astype(np.int64)
    dest = np.zeros((20, width), dtype)
    out = scatter_pages(torch.from_numpy(ws), torch.from_numpy(idx),
                        torch.from_numpy(dest.copy())).numpy()
    ref = page_scatter_ref(torch.from_numpy(ws), torch.from_numpy(idx),
                           torch.from_numpy(dest.copy())).numpy()
    jk = np.asarray(jx.scatter(jnp.asarray(ws), jnp.asarray(idx.astype(np.int32)),
                               jnp.asarray(dest), interpret=True))
    jr = np.asarray(jx.scatter_ref(jnp.asarray(ws), jnp.asarray(idx), 20))
    for other in (ref, jk, jr):
        assert other.tobytes() == out.tobytes()


def test_scatter_keeps_unwritten_rows():
    dest = torch.full((6, 8), 7, dtype=torch.uint8)
    out = scatter_pages(torch.ones((2, 8), dtype=torch.uint8),
                        torch.tensor([4, 1]), dest)
    assert out is dest
    assert out[[1, 4]].eq(1).all() and out[[0, 2, 3, 5]].eq(7).all()


@pytest.mark.parametrize("bad", [
    lambda t: gather_pages(t, torch.tensor([0, 9])),              # out of range
    lambda t: gather_pages(t, torch.tensor([0, 1], dtype=torch.int32)),
    lambda t: gather_pages(t[0], torch.tensor([0])),              # not 2-D
    lambda t: scatter_pages(t[:2], torch.tensor([0, 1]), t.float()),
])
def test_page_wrappers_reject_bad_input(bad):
    with pytest.raises((IndexError, TypeError, ValueError)):
        bad(torch.zeros((4, 8), dtype=torch.uint8))


def test_fuse_engine_follows_device_and_matches_jax(jx):
    pages = [9, 2, 5, 0, 7]
    data = _rows(5, 4096, np.uint8, 5).tobytes()
    assert default_fuse_engine("cpu") == "numpy"
    assert default_fuse_engine("cuda") == "cuda"
    idx_t, blk_t = fuse_ws_block(pages, data, engine="auto", device="cpu")
    idx_j, blk_j = jx.fuse(pages, data, engine="pallas")
    np.testing.assert_array_equal(idx_t, idx_j)
    assert blk_t.tobytes() == blk_j.tobytes()
    with pytest.raises(ValueError):
        fuse_ws_block(pages, data, engine="cuda", device="cpu")


# -- flash attention ---------------------------------------------------------


def _qkv(B, S, H, KV, D, dtype, seed=42):
    """Inputs from a numpy seed: torch tensors of ``dtype`` and the float32
    arrays they came from."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D))]
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs], arrs


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


@pytest.mark.parametrize("B,S,H,KV,D,dtype", FLASH_SHAPES)
def test_plain_attention_matches_jax(jx, B, S, H, KV, D, dtype):
    """ops.mha's plain path and the port's chunked_attention against the
    Pallas kernel (interpret) and the JAX oracle."""
    jnp = jx.jnp
    (q, k, v), arrs = _qkv(B, S, H, KV, D, dtype)
    jq, jk, jv = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs)
    jax_out = _f32(jx.mha(jq, jk, jv, causal=True, interpret=True))
    jax_ref = _f32(jnp.moveaxis(jx.flash_ref(
        jnp.moveaxis(jq, 1, 2), jnp.moveaxis(jk, 1, 2), jnp.moveaxis(jv, 1, 2),
        causal=True), 1, 2))
    outs = {"mha": mha(q, k, v, causal=True),
            "chunked": chunked_attention(q, k, v, causal=True, chunk=128),
            "ref": flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2)).transpose(1, 2)}
    for name, out in outs.items():
        assert out.dtype == q.dtype and tuple(out.shape) == (B, S, H, D), name
        for want in (jax_out, jax_ref):
            np.testing.assert_allclose(_f32(out), want, atol=ATOL[dtype], err_msg=name)


def test_mha_rejects_bad_shapes():
    q = torch.zeros(1, 8, 4, 32)
    with pytest.raises(ValueError):
        mha(q, torch.zeros(1, 8, 3, 32), torch.zeros(1, 8, 3, 32))   # H % KV
    with pytest.raises(ValueError):
        mha(q, torch.zeros(1, 9, 2, 32), torch.zeros(1, 9, 2, 32))   # Sq != Skv
    with pytest.raises(TypeError):
        mha(q, torch.zeros(1, 8, 2, 32), torch.zeros(1, 8, 2, 32).double())


ALIGNED16_CASES = {                   # name: (tensor, whether its rows are aligned)
    "contiguous": (lambda: torch.zeros(4, 8, 2, 64), True),
    "one float in": (lambda: torch.zeros(4 * 8 * 2 * 64 + 1)[1:].view(4, 8, 2, 64), False),
    "column slice": (lambda: torch.zeros(4, 8, 2, 128)[..., :64], True),
    "odd row stride": (lambda: torch.zeros(4, 8, 2, 65)[..., :64], False),
    "odd stride of a length-1 dim": (
        lambda: torch.zeros(1024).as_strided((2, 1, 2, 64), (256, 3, 128, 1)), True),
    "bf16 rows of 8 bytes": (lambda: torch.zeros(2, 3, 4, dtype=torch.bfloat16), False),
}


@pytest.mark.parametrize("case", list(ALIGNED16_CASES))
def test_aligned16(case):
    """The rule the scan wrappers (B5, B6) hold their inputs to before a
    launch: every row the kernels copy in 16-byte pieces starts on a
    16-byte boundary (strides of length-1 dimensions do not count)."""
    make, want = ALIGNED16_CASES[case]
    assert aligned16(make()) is want


# -- the kernels on the card ---------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n,width", [(4096, 4096), (1000, 4100),
                                     (3, 4096),       # fewer rows than one CTA's warps
                                     (1057, 4096),    # not a multiple of the rows a CTA
                                     (64, 32768),     # each lane loops over the row
                                     (3, 4100)])      # byte path, one part-filled CTA
def test_cuda_gather_scatter_match_plain(cuda, n, width):
    g = torch.Generator(device=cuda).manual_seed(0)
    table = torch.randint(0, 256, (n, width), dtype=torch.uint8, device=cuda,
                          generator=g)
    idx = torch.randperm(n, device=cuda, generator=g)
    assert torch.equal(gather_pages(table, idx), page_gather_ref(table, idx))
    sub = idx[: n // 2].contiguous()
    ws = table[: n // 2].contiguous()
    assert torch.equal(scatter_pages(ws, sub, table.clone()),
                       page_scatter_ref(ws, sub, table.clone()))


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,D,dtype",
                         FLASH_SHAPES + [(1, 64, 16, 16, 128, "bfloat16"),
                                         (1, 100, 4, 2, 32, "float32")])
def test_cuda_flash_matches_plain(cuda, B, S, H, KV, D, dtype):
    (q, k, v), _ = _qkv(B, S, H, KV, D, dtype)
    q, k, v = q.to(cuda), k.to(cuda), v.to(cuda)
    out = mha(q, k, v)
    ref = mha_ref(q, k, v)
    np.testing.assert_allclose(_f32(out.cpu()), _f32(ref.cpu()), atol=ATOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["gather", "scatter"])
def test_cuda_page_index_out_of_range_stops_the_kernel(cuda, op):
    """On the card the indices are checked inside the kernel: an index past
    the indexed rows trips a device-side assert (run in a child process,
    whose CUDA context the assert ends)."""
    call = ("gather_pages(t, i)" if op == "gather"
            else "scatter_pages(t[:2].contiguous(), i, t)")
    code = ("import torch\n"
            "from repro_torch.kernels import gather_pages, scatter_pages\n"
            "t = torch.zeros((4, 4096), dtype=torch.uint8, device='cuda')\n"
            "i = torch.tensor([0, 9], device='cuda')\n"
            f"{call}\n"
            "torch.cuda.synchronize()\n")
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "PYTHONPATH": src + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode != 0
    assert "device-side assert" in proc.stdout + proc.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 64, 100, 1056])
@pytest.mark.parametrize("D", [32, 64, 80, 128])
def test_cuda_flash_bf16_within_four_ulps(cuda, D, S):
    """The tensor-core route (bf16) against the float32 plain version, GQA
    with H / KV = 4, causal, at ragged and one-row lengths: within four
    bf16 ulps at the output's largest magnitude (``KERNEL_ULPS`` of
    chip_smoke.py)."""
    (q, k, v), _ = _qkv(2, S, 8, 2, D, "bfloat16", seed=S + D)
    q, k, v = q.to(cuda), k.to(cuda), v.to(cuda)
    out = mha(q, k, v)
    ref = mha_ref(q, k, v).float()
    ulp = 2.0 ** (np.floor(np.log2(float(ref.abs().max()))) - 7)
    assert bool(torch.isfinite(out).all())
    assert float((out.float() - ref).abs().max()) <= 4 * ulp


@pytest.mark.cuda
def test_cuda_mha_rejects_misaligned_bf16(cuda):
    """The bf16 kernel copies 16-byte vectors: a contiguous view that
    starts off a 16-byte boundary is refused, not read misaligned."""
    base = torch.zeros(1 * 64 * 4 * 64 + 1, dtype=torch.bfloat16, device=cuda)
    q = base[1:].view(1, 64, 4, 64)
    assert q.is_contiguous() and q.data_ptr() % 16
    with pytest.raises(ValueError):
        mha(q, q, q)


@pytest.mark.cuda
def test_cuda_fuse_engine_matches_numpy(cuda):
    pages = list(np.random.default_rng(6).permutation(300))
    data = _rows(300, 4096, np.uint8, 7).tobytes()
    idx_c, blk_c = fuse_ws_block(pages, data, engine="auto", device=cuda)
    idx_n, blk_n = fuse_ws_block(pages, data, engine="numpy")
    np.testing.assert_array_equal(idx_c, idx_n)
    assert blk_c.tobytes() == blk_n.tobytes()
