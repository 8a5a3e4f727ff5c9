"""The port's training slice against the JAX package's, on the CPU at SMOKE
size, and flash attention's backward kernel on the card.

Every family's ``loss`` and its gradient over every param leaf are held to
``jax.value_and_grad`` of the JAX ``loss`` (float32 twins on both sides,
params from ``host_initialize``); two train steps to the JAX step; a
checkpoint's ``.mem`` and manifest and the synthetic corpus byte for byte.
Port-only checks: ``remat`` and ``microbatches``, restore in both modes,
``read_shard``, a preempt-and-restart run, the training CLI, and flash
attention's backward oracle (against autograd of the plain version and
``jax.grad`` of the JAX package's chunked attention).  Tests marked
``cuda`` hold the backward kernel to its oracle and check that the kernels
without a backward refuse an autograd graph; they skip without a card.
"""
import dataclasses
import filecmp
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import SMOKES  # noqa: E402
from repro_torch.data import PrefetchLoader, TokenDataset, synthesize_corpus  # noqa: E402
from repro_torch.kernels import LAUNCHES, KernelError, mha, reset_launches  # noqa: E402
from repro_torch.kernels.flash_attention import mha_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention_bwd  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_ref, mha_lse_ref)
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.training import (OptConfig, SimulatedPreemption, Trainer,  # noqa: E402
                                  TrainLoopConfig)
from repro_torch.training import optimizer as opt_lib  # noqa: E402
from repro_torch.training.checkpoint import (AsyncCheckpointer, read_shard,  # noqa: E402
                                             restore_checkpoint, save_checkpoint)
from repro_torch.training.optimizer import tree_leaves  # noqa: E402

FAMILIES = ["olmo-1b", "qwen2-7b", "pixtral-12b", "deepseek-moe-16b", "zamba2-1.2b",
            "rwkv6-7b", "seamless-m4t-medium"]
SEQ, BATCH = 32, 2
# float32 twins in two frameworks differ in the order of their sums: the
# losses agreed to 1.5e-7 (relative) and each gradient leaf to 4.3e-6 of
# its largest magnitude (zamba2-1.2b, the worst, through its chunked SSD
# scan) on this host; the bounds are about five times that.
LOSS_RTOL, GRAD_RTOL = 1e-6, 2e-5
# float32 attention gradients: the forward kernel check's tolerance
BWD_ATOL = 2e-5


@pytest.fixture(scope="module")
def jx():
    """The JAX package's steps, optimizer, checkpoint and corpus (skips
    where JAX is absent)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import SMOKES as JAX_SMOKES
    from repro.data import synthesize_corpus as jax_corpus
    from repro.launch import steps as jax_steps
    from repro.models import get_family
    from repro.nn import layers as jax_layers
    from repro.nn import spec as jax_spec
    from repro.training import checkpoint as jax_ckpt
    from repro.training import optimizer as jax_opt
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, smokes=JAX_SMOKES, steps=jax_steps, spec=jax_spec,
        layers=jax_layers, family=get_family, opt=jax_opt, ckpt=jax_ckpt,
        corpus=jax_corpus)


@pytest.fixture
def cuda():
    """The CUDA device, or a skip: decided here, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def f32_twins(jx, name):
    """Both packages' float32 config and params of ``name``'s SMOKE config,
    from the same ``host_initialize`` arrays."""
    cfg = dataclasses.replace(SMOKES[name], dtype="float32")
    jcfg = dataclasses.replace(jx.smokes[name], dtype=jx.jnp.float32)
    specs = jx.steps.param_specs(jcfg)
    host = jx.spec.host_initialize(specs, seed=0)
    jparams = jx.spec.map_leaves(
        lambda p, s: jx.jnp.asarray(host[p]).astype(jx.jnp.float32), specs)
    params = convert.params_from_numpy(
        {p: np.array(a) for p, a in tree_leaves(jx.jax.tree.map(np.asarray, jparams))},
        "cpu")
    return cfg, jcfg, params, jparams


def jax_tree(jx, tree) -> dict:
    return dict(tree_leaves(jx.jax.tree.map(np.asarray, tree)))


def assert_grads_close(got: dict, want: dict, rtol: float = GRAD_RTOL):
    assert set(p for p, _ in tree_leaves(got)) == set(want)
    for path, g in tree_leaves(got):
        w = want[path]
        assert g.shape == w.shape, path
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.float().numpy() - w).max())
        assert err <= rtol * scale, (path, err, scale)


# -- loss and gradients against the JAX package ------------------------------------


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_grads_match_jax(jx, name):
    """The VLM drops its patch positions before the head; the MoE routes
    in float32 as the JAX package does; the encoder-decoder's float32 run
    takes a float32 config (ROADMAP C3)."""
    cfg, jcfg, params, jparams = f32_twins(jx, name)
    seq = SEQ + (cfg.n_patches if cfg.family == "vlm" else 0)
    batch = steps.make_batch(cfg, seq, BATCH, "train", 3)
    fam = jx.family(jcfg)
    jl, jg = jx.jax.jit(jx.jax.value_and_grad(lambda p, b: fam.loss(jcfg, p, b)))(
        jparams, {k: jx.jnp.asarray(v) for k, v in batch.items()})
    loss, grads = steps.loss_and_grads(cfg, params, batch)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    assert_grads_close(grads, jax_tree(jx, jg))


@pytest.mark.parametrize("name,check", [("olmo-1b", "remat"), ("deepseek-moe-16b", "remat"),
                                        ("zamba2-1.2b", "remat"), ("rwkv6-7b", "remat"),
                                        ("olmo-1b", "microbatches")])
def test_remat_and_microbatches_keep_the_gradient(name, check):
    """``remat=True`` recomputes each layer (each group for the MoE and the
    hybrid) in the backward: the same arithmetic, so the same loss and
    gradients.  ``microbatches=2`` averages two half-batch gradients: the
    same mean over equal halves, summed in another order."""
    cfg = dataclasses.replace(SMOKES[name], dtype="float32")
    params = opt_lib.tree_map(lambda t: t.float(), steps.init_params(cfg, 0, "cpu"))
    batch = steps.make_batch(cfg, SEQ, 4, "train", 5)
    if check == "remat":
        want = steps.loss_and_grads(cfg, params, batch)
        got = steps.loss_and_grads(cfg, params, batch, remat=True)
        assert float(got[0]) == float(want[0])
        assert_grads_close(got[1], {p: g.numpy() for p, g in tree_leaves(want[1])}, 1e-6)
        with pytest.raises(ValueError):
            steps.loss_and_grads(cfg, params, batch, remat=True, remat_policy="dots")
        return
    opt = OptConfig(kind="sgdm", lr=1e-2, warmup_steps=0, total_steps=4)
    state = opt_lib.init_state(params, opt)
    p1, _, m1 = steps.build_train_step(cfg, opt, remat=False)(params, state, batch)
    p2, _, m2 = steps.build_train_step(cfg, opt, remat=False, microbatches=2)(
        params, state, batch)
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]), rtol=1e-5)
    for (path, a), (_, b) in zip(tree_leaves(p2), tree_leaves(p1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7, err_msg=path)


def test_chunked_ce_equals_dense_ce():
    """``ce_from_hidden`` over chunks of 8 (the last one padded with -1
    targets) equals ``next_token_loss`` over the forward's whole logits."""
    from repro_torch.models import transformer
    cfg = dataclasses.replace(SMOKES["olmo-1b"], dtype="float32", ce_chunk=8)
    params = opt_lib.tree_map(lambda t: t.float(), steps.init_params(cfg, 0, "cpu"))
    batch = steps.make_batch(cfg, SEQ, BATCH, "train", 2)
    dense = transformer.next_token_loss(steps.build_forward(cfg)(params, batch),
                                        batch["tokens"])
    np.testing.assert_allclose(float(transformer.loss(cfg, params, batch)),
                               float(dense), rtol=1e-6)


@pytest.mark.parametrize("kind", ["sgdm", "adamw"])
def test_two_train_steps_match_jax(jx, kind):
    """olmo-1b's float32 twin, two steps, the second in the cosine branch.
    ``lr`` and ``count`` are exact.  SGD-momentum's params are held within
    1e-7.  Adam's first steps are sign-like: an entry whose gradient is at
    rounding level can take the other sign, so every entry is held within
    2 * (lr_1 + lr_2), and all but a thousandth of each leaf's entries
    within 1e-6."""
    cfg, jcfg, params, jparams = f32_twins(jx, "olmo-1b")
    opt = OptConfig(kind=kind, lr=1e-3, warmup_steps=1, total_steps=4)
    jopt = jx.opt.OptConfig(kind=kind, lr=1e-3, warmup_steps=1, total_steps=4)
    jstep = jx.jax.jit(jx.steps.build_train_step(jcfg, jopt, remat=False))
    step = steps.build_train_step(cfg, opt, remat=False)
    jstate, state = jx.opt.init_state(jparams, jopt), opt_lib.init_state(params, opt)
    lrs = []
    for i in range(2):
        batch = steps.make_batch(cfg, SEQ, BATCH, "train", 10 + i)
        jparams, jstate, jm = jstep(jparams, jstate,
                                    {k: jx.jnp.asarray(v) for k, v in batch.items()})
        params, state, m = step(params, state, batch)
        assert m["lr"].dtype == torch.float32
        assert np.asarray(jm["lr"]).tobytes() == m["lr"].numpy().tobytes()
        assert int(state["count"]) == int(jstate["count"]) == i + 1
        assert state["count"].dtype == torch.int32
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=GRAD_RTOL)
        lrs.append(float(m["lr"]))
    want = jax_tree(jx, jparams)
    for path, p in tree_leaves(params):
        diff = np.abs(p.numpy() - want[path])
        if kind == "sgdm":
            assert diff.max() <= 1e-7, path
        else:
            assert diff.max() <= 2 * sum(lrs), path
            assert (diff > 1e-6).mean() <= 1e-3, path
    assert set(state) == set(jstate)
    for name in [k for k in state if k != "count"]:
        assert {p for p, _ in tree_leaves(state[name])} == set(jax_tree(jx, jstate[name]))


def test_lr_schedule_matches_jax(jx):
    opt = OptConfig(lr=3e-4, warmup_steps=5, total_steps=40)
    jopt = jx.opt.OptConfig(lr=3e-4, warmup_steps=5, total_steps=40)
    for step in (0, 1, 4, 5, 6, 17, 39, 40, 55):
        assert (opt_lib.lr_at(opt, step).numpy().tobytes()
                == np.asarray(jx.opt.lr_at(jopt, step)).tobytes()), step
    specs = steps.param_specs(SMOKES["olmo-1b"])
    assert {p: s.dtype for p, s in tree_leaves(opt_lib.state_specs(specs, opt))}[
        "count"] == "int32"
    with pytest.raises(ValueError):
        opt_lib.state_specs(specs, OptConfig(kind="lion"))


# -- checkpoints and the corpus, byte for byte -------------------------------------


def _state_with_values(params, opt: OptConfig, seed: int):
    """An optimizer state of ``params``' shape with random moments and a
    count of 3, as numpy arrays (fed to both packages)."""
    rng = np.random.default_rng(seed)
    moment = {p: rng.standard_normal(t.shape, dtype=np.float32)
              for p, t in tree_leaves(params)}
    return {"mu": moment, "nu": {p: np.abs(a) for p, a in moment.items()},
            "count": np.asarray(3, np.int32)}


def test_checkpoint_bytes_match_jax(jx, tmp_path):
    """qwen2-7b SMOKE in bfloat16 (its biases in the tree), moments and a
    count: the same ``.mem`` and ``.manifest.json`` from both packages."""
    cfg, jcfg = SMOKES["qwen2-7b"], jx.smokes["qwen2-7b"]
    specs = jx.steps.param_specs(jcfg)
    host = jx.spec.host_initialize(specs, seed=4)
    jparams = jx.spec.map_leaves(lambda p, s: jx.jnp.asarray(host[p]).astype(s.dtype), specs)
    params = steps.init_params(cfg, 4, "cpu")
    st = _state_with_values(params, OptConfig(), 6)
    nest = convert.params_from_numpy
    state = {"mu": nest(st["mu"], "cpu"), "nu": nest(st["nu"], "cpu"),
             "count": torch.from_numpy(st["count"])}
    jstate = {"mu": jx.jax.tree.map(jx.jnp.asarray, _nested(st["mu"])),
              "nu": jx.jax.tree.map(jx.jnp.asarray, _nested(st["nu"])),
              "count": jx.jnp.asarray(st["count"])}
    mine = save_checkpoint(str(tmp_path / "torch"), params, state, 11)
    theirs = jx.ckpt.save_checkpoint(str(tmp_path / "jax"), jparams, jstate, 11)
    for suffix in (".mem", ".manifest.json"):
        assert filecmp.cmp(mine + suffix, theirs + suffix, shallow=False), suffix


def _nested(flat: dict) -> dict:
    return steps._unflatten(list(flat), list(flat.values()))


def test_corpus_and_batches_match_jax(jx, tmp_path):
    mine = synthesize_corpus(str(tmp_path / "t.bin"), 50_000, 1000, seed=3)
    theirs = jx.corpus(str(tmp_path / "j.bin"), 50_000, 1000, seed=3)
    assert filecmp.cmp(mine, theirs, shallow=False)
    ds = TokenDataset(mine, 32)
    loader = PrefetchLoader(ds, 4, start_step=7)
    try:
        step, tokens = next(loader)
    finally:
        loader.close()
    assert step == 7 and tokens.dtype == np.int32 and tokens.shape == (4, 32)
    np.testing.assert_array_equal(tokens, ds.batch(7, 4))


# -- port-only: restore, restart, CLI -----------------------------------------------


@pytest.fixture
def saved(tmp_path):
    """A qwen2-7b SMOKE checkpoint (bfloat16 params, AdamW state) at step 7."""
    cfg = SMOKES["qwen2-7b"]
    params = steps.init_params(cfg, 5, "cpu")
    st = _state_with_values(params, OptConfig(), 8)
    state = {"mu": convert.params_from_numpy(st["mu"], "cpu"),
             "nu": convert.params_from_numpy(st["nu"], "cpu"),
             "count": torch.tensor(3, dtype=torch.int32)}
    base = save_checkpoint(str(tmp_path / "ck"), params, state, 7)
    return base, params, state


@pytest.mark.parametrize("mode", ["lazy", "reap"])
def test_restore_is_bitwise(saved, mode):
    """Both modes give the saved tensors bit for bit, in the template's
    dtypes; ``reap`` reads once and faults no page, ``lazy`` faults every
    page."""
    base, params, state = saved
    like_p = opt_lib.tree_map(torch.zeros_like, params)
    like_s = opt_lib.tree_map(torch.zeros_like, state)
    p2, s2, step, stats = restore_checkpoint(base, like_p, like_s, mode=mode)
    assert step == 7
    for (path, a), (_, b) in zip(tree_leaves(params), tree_leaves(p2)):
        assert a.dtype == b.dtype and torch.equal(a.view(-1).view(torch.uint8),
                                                  b.view(-1).view(torch.uint8)), path
    for (path, a), (_, b) in zip(tree_leaves(state), tree_leaves(s2)):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    pages = stats["bytes"] // 4096
    assert stats["n_faults"] == (0 if mode == "reap" else pages)
    with pytest.raises(ValueError):
        restore_checkpoint(base, like_p, like_s, mode="serve")


def test_read_shard_reads_rows(saved):
    base, params, _ = saved
    table = params["embed"]["table"]
    got = read_shard(base, "params/embed/table", 3, 9)
    assert got.dtype == torch.bfloat16 and torch.equal(got, table[3:9])
    got = read_shard(base, "opt/mu/layers/attn/wq", 1, 2)
    assert got.shape == (1,) + tuple(params["layers"]["attn"]["wq"].shape[1:])


def test_async_checkpointer_keeps_two_and_reraises(tmp_path, saved):
    _, params, state = saved
    ck = AsyncCheckpointer(str(tmp_path / "ckpts"))
    for step in (1, 2, 3):
        ck.save(params, state, step)
    ck.wait()
    assert ck.latest().endswith("ckpt_00000003")
    assert sorted(p.name for p in (tmp_path / "ckpts").glob("*.mem")) == [
        "ckpt_00000002.mem", "ckpt_00000003.mem"]
    assert ck.last_stage_s is not None and ck.last_write_s is not None
    ck.save({"bad": object()}, state, 4)       # the background write fails
    with pytest.raises(Exception):
        ck.wait()


def test_preempt_restart_is_deterministic(tmp_path):
    """tests/test_serving_training.py:68 on the port: preempted at step 4,
    restarted from the step-4 checkpoint by REAP restore, it ends at the
    same losses as an uninterrupted run (bitwise on the CPU)."""
    cfg = SMOKES["olmo-1b"]
    corpus = synthesize_corpus(str(tmp_path / "c.bin"), 100_000, cfg.vocab)
    loop = TrainLoopConfig(total_steps=6, checkpoint_every=2, batch_size=2, seq_len=32)
    opt = OptConfig(lr=1e-3, warmup_steps=2, total_steps=6)
    tr = Trainer(cfg, opt, loop, corpus, str(tmp_path / "ck"), preempt_at=4, device="cpu")
    with pytest.raises(SimulatedPreemption):
        tr.run()
    out = Trainer(cfg, opt, loop, corpus, str(tmp_path / "ck"), device="cpu").run()
    assert out["final_step"] == 6 and len(out["losses"]) == 2
    assert out["restore_stats"]["n_faults"] == 0
    ref = Trainer(cfg, opt, loop, corpus, str(tmp_path / "ck2"), device="cpu").run()
    assert ref["restore_stats"] is None
    np.testing.assert_array_equal(out["losses"], ref["losses"][-2:])


def test_train_cli_on_the_cpu(tmp_path, capsys):
    args = ["--arch", "olmo-1b", "--smoke", "--device", "cpu", "--steps", "3",
            "--batch", "2", "--seq", "16", "--checkpoint-every", "2",
            "--workdir", str(tmp_path)]
    train_cli.main(args + ["--preempt-at", "2"])
    assert "preempted at step 2" in capsys.readouterr().out
    train_cli.main(args)
    out = capsys.readouterr().out
    assert "arch=olmo-1b-smoke steps=3" in out and "restored via reap" in out
    assert "(0 faults)" in out


def test_trainer_batches_carry_the_stub_inputs(tmp_path):
    """The JAX Trainer's zero patch embeddings (VLM) and frames (encdec)."""
    loop = TrainLoopConfig(batch_size=2, seq_len=32)
    corpus = synthesize_corpus(str(tmp_path / "c.bin"), 1_000, 100)
    tokens = np.zeros((2, 32), np.int32)
    for name in ("pixtral-12b", "seamless-m4t-medium"):
        cfg = SMOKES[name]
        tr = Trainer(cfg, OptConfig(), loop, corpus, str(tmp_path / name), device="cpu")
        key, want = (("patch_embeds", (2, cfg.n_patches, cfg.d_model)) if name == "pixtral-12b"
                     else ("frames", (2, max(32 // cfg.frame_stride, 1), cfg.d_model)))
        b = tr._make_batch(tokens)
        assert tuple(b[key].shape) == want and b[key].dtype == torch.bfloat16
        assert not b[key].any()


# -- flash attention's backward oracle ------------------------------------------------

BWD_SHAPES = [                          # (B, S, H, KV, D, causal)
    (2, 40, 4, 2, 16, True),            # GQA, causal, a ragged length
    (1, 24, 2, 2, 32, False),           # bidirectional (an encoder's)
]


def _attn_inputs(B, S, H, KV, D, dtype=torch.float32, device="cpu", seed=0):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, dtype)
    return r(B, S, H, D), r(B, S, KV, D), r(B, S, KV, D), r(B, S, H, D)


@pytest.mark.parametrize("B,S,H,KV,D,causal", BWD_SHAPES)
def test_bwd_ref_matches_autograd_and_jax(jx, B, S, H, KV, D, causal):
    """The explicit formulas against autograd of ``mha_ref`` and ``jax.grad``
    of the JAX package's ``chunked_attention`` (which the JAX model
    differentiates: no Pallas kernel has a backward), float32."""
    q, k, v, do = _attn_inputs(B, S, H, KV, D)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = mha_ref(*leaves, causal=causal)
    want = torch.autograd.grad(out, leaves, do)
    got = flash_attention_bwd_ref(q, k, v, out.detach(), mha_lse_ref(q, k, causal=causal),
                                  do, causal)
    jnp = jx.jnp

    def f(a, b, c):
        o = jx.layers.chunked_attention(a, b, c, causal=causal, chunk=16)
        return jnp.sum(o * jnp.asarray(do.numpy()))
    jgot = jx.jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(t.numpy()) for t in (q, k, v)))
    for name, g, w, j in zip("qkv", got, want, jgot):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=BWD_ATOL, err_msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=BWD_ATOL, err_msg=name)


def test_cpu_wrappers_stay_differentiable():
    """On CPU tensors every wrapper runs its plain version, which autograd
    differentiates: only the kernels refuse a graph."""
    from repro_torch.kernels import gqa_decode, ssd_scan, wkv6
    q, k, v, _ = _attn_inputs(1, 16, 2, 1, 16)
    q.requires_grad_(True)
    mha(q, k, v).sum().backward()
    assert q.grad is not None and q.grad.abs().sum() > 0
    q1 = q.detach()[:, :1].clone().requires_grad_(True)
    gqa_decode(q1, k, v, torch.full((1,), 16, dtype=torch.int32)).sum().backward()
    assert q1.grad is not None
    x = torch.randn(1, 8, 2, 4, requires_grad=True)
    y, _ = ssd_scan(x, torch.rand(1, 8, 2), -torch.rand(2), torch.randn(1, 8, 4),
                    torch.randn(1, 8, 4), torch.zeros(1, 2, 4, 4), chunk=4)
    y.sum().backward()
    assert x.grad is not None
    r = torch.randn(1, 8, 2, 4, requires_grad=True)
    y, _ = wkv6(r, torch.randn(1, 8, 2, 4), torch.randn(1, 8, 2, 4),
                -torch.rand(1, 8, 2, 4), torch.randn(2, 4), torch.zeros(1, 2, 4, 4), chunk=4)
    y.sum().backward()
    assert r.grad is not None


# -- on the card ------------------------------------------------------------------------

CUDA_BWD_SHAPES = [                     # (B, S, H, KV, D, dtype, causal)
    (2, 256, 4, 2, 64, "float32", True),
    (1, 200, 8, 8, 128, "float32", True),
    (2, 192, 6, 2, 80, "float32", False),
    (1, 130, 4, 4, 32, "float32", True),
    (2, 256, 8, 2, 128, "bfloat16", True),
    (1, 128, 4, 4, 64, "bfloat16", False),
    (2, 200, 4, 4, 32, "bfloat16", True),      # the tensor-core route at every head dim,
    (1, 200, 6, 2, 80, "bfloat16", True),      # at a ragged causal length (D = 80: five
    (2, 200, 8, 2, 64, "bfloat16", True),      # k-steps), GQA with G = 4,
    (1, 136, 4, 4, 128, "bfloat16", False),    # and bidirectional past a tile at D = 128
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,KV,D,dtype,causal", CUDA_BWD_SHAPES)
def test_cuda_flash_bwd_matches_plain(cuda, B, S, H, KV, D, dtype, causal):
    """The backward kernel against ``flash_attention_bwd_ref`` on the same
    inputs (the kernel's own output and LSE): float32 within ``BWD_ATOL``
    of each output's largest magnitude (at least 1), bfloat16 within four
    ulps of it (both sides compute in float32; the kernel rounds once).
    Then through autograd: ``mha`` on inputs that require grad launches
    the forward once and the backward once, and its gradients are
    autograd-of-``mha_ref``'s within the same bounds."""
    tdt = getattr(torch, dtype)
    q, k, v, do = _attn_inputs(B, S, H, KV, D, tdt, cuda, seed=S)
    from repro_torch.kernels.flash_attention.ops import _forward
    o, lse = _forward(q, k, v, causal, want_lse=True)
    torch.testing.assert_close(lse, mha_lse_ref(q, k, causal=causal), atol=1e-4, rtol=0)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want = flash_attention_bwd_ref(q, k, v, o, lse, do, causal)
    _close(got, want, dtype)
    reset_launches()
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = mha(*leaves, causal=causal)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, leaves, do)
    assert LAUNCHES["flash_attention"] == 1 and LAUNCHES["flash_attention_bwd"] == 1
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = torch.autograd.grad(mha_ref(*ref_leaves, causal=causal), ref_leaves, do)
    _close(grads, [r.float() for r in ref], dtype, extra_ulps=1)


@pytest.mark.cuda
def test_cuda_flash_bwd_bf16_is_deterministic(cuda):
    """Two calls of the bfloat16 backward kernel on the same inputs give
    bitwise-equal dq, dk and dv: no atomics and a fixed order of sums (GQA's
    dK and dV summed over the G query heads inside one CTA), so a restarted
    run's losses are bitwise the uninterrupted run's."""
    q, k, v, do = _attn_inputs(2, 200, 8, 2, 128, torch.bfloat16, cuda, seed=3)
    from repro_torch.kernels.flash_attention.ops import _forward
    o, lse = _forward(q, k, v, True, want_lse=True)
    first = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    second = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    for name, a, b in zip("qkv", first, second):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)), name


def _close(got, want, dtype, extra_ulps=0):
    for name, g, w in zip("qkv", got, want):
        w = w.float()
        m = float(w.abs().max())
        if dtype == "bfloat16":
            atol = (4 + extra_ulps) * 2.0 ** (np.floor(np.log2(m)) - 7)
        else:
            atol = BWD_ATOL * max(1.0, m)
        err = float((g.float() - w).abs().max())
        assert err <= atol, (name, err, atol)


@pytest.mark.cuda
def test_cuda_serving_forward_keeps_exact_counts(cuda):
    """Under no grad (serving, decode) ``mha`` launches the forward alone:
    no LSE, no graph, one launch."""
    q, k, v, _ = _attn_inputs(1, 64, 4, 4, 64, torch.bfloat16, cuda)
    reset_launches()
    with torch.no_grad():
        out = mha(q.requires_grad_(True), k, v)
    assert out.grad_fn is None
    assert LAUNCHES["flash_attention"] == 1 and LAUNCHES["flash_attention_bwd"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["decode_attention", "gather_pages", "scatter_pages"])
def test_cuda_kernels_without_backward_refuse_a_graph(cuda, kernel):
    """B4, B1 and B2 raise on a CUDA input that requires grad while grad is
    enabled, rather than return an output without a ``grad_fn``: decode
    and the page install run under no grad, so these kernels have no
    backward.  (B5 and B6 have one: ``tests/test_torch_scan_bwd.py``.)"""
    from repro_torch.kernels import gather_pages, gqa_decode, scatter_pages
    f = dict(device=cuda, requires_grad=True)
    calls = {
        "decode_attention": lambda: gqa_decode(
            torch.randn(1, 1, 4, 64, **f), torch.randn(1, 64, 4, 64, device=cuda),
            torch.randn(1, 64, 4, 64, device=cuda),
            torch.full((1,), 64, dtype=torch.int32, device=cuda)),
        "gather_pages": lambda: gather_pages(
            torch.randn(8, 1024, **f), torch.arange(4, device=cuda)),
        "scatter_pages": lambda: scatter_pages(
            torch.randn(4, 1024, **f), torch.arange(4, device=cuda),
            torch.zeros(8, 1024, device=cuda)),
    }
    with pytest.raises(KernelError, match="no backward kernel"):
        calls[kernel]()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["olmo-1b", "pixtral-12b", "deepseek-moe-16b",
                                  "seamless-m4t-medium", "zamba2-1.2b", "rwkv6-7b"])
def test_cuda_family_grads_through_kernels_match_plain(cuda, name):
    """Every family's loss on the card: every self-attention (an encoder's
    bidirectional one too) runs B3 forward and backward once, each Mamba2
    layer B6 forward and backward once, each RWKV6 layer B5 forward and
    backward once, nothing else launches (a prompt's cross-attention is
    plain, as in the JAX package), and the float32 twin's loss and
    gradients match the plain versions' within the CPU's JAX bounds."""
    cfg = dataclasses.replace(SMOKES[name], dtype="float32")
    params = opt_lib.tree_map(lambda t: t.float(), steps.init_params(cfg, 0, cuda))
    seq = 64 + (cfg.n_patches if cfg.family == "vlm" else 0)
    batch = steps.make_batch(cfg, seq, BATCH, "train", 1)
    reset_launches()
    loss, grads = steps.loss_and_grads(cfg, params, batch)
    launches = {k: n for k, n in LAUNCHES.items() if n}
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.attn_every
        assert launches == {"flash_attention": n_attn, "flash_attention_bwd": n_attn,
                            "ssd_scan": cfg.n_layers, "ssd_scan_bwd": cfg.n_layers}
    elif cfg.family == "rwkv":
        assert launches == {"wkv6_scan": cfg.n_layers, "wkv6_scan_bwd": cfg.n_layers}
    else:
        assert launches["flash_attention"] == launches["flash_attention_bwd"] > 0
        assert set(launches) == {"flash_attention", "flash_attention_bwd"}
    ploss, pgrads = steps.loss_and_grads(cfg, params, batch, plain=True)
    np.testing.assert_allclose(float(loss), float(ploss), rtol=LOSS_RTOL)
    assert_grads_close(opt_lib.tree_map(lambda t: t.cpu(), grads),
                       {p: g.cpu().numpy() for p, g in tree_leaves(pgrads)})
