"""The port's MoE family and the executor's route-then-fault branch against
the JAX package's.

Both packages get the same ``host_initialize`` parameters and the same
numpy inputs (deepseek-moe-16b and llama4-maverick SMOKE).  In float32
the logits agree to rounding (``atol = rtol = 1e-4``) and the port routes
every token as the JAX package does.  In bfloat16 the two frameworks round
the router's input differently in its last bit, and a token whose k-th and
(k+1)-th experts are that close swaps one for the other (a top-1 swap
moves that token's logits past ``BF16_ATOL``).  So the bfloat16 runs route
by the JAX package's decisions, recorded from its top-k, and every
decision the port's own top-k would take otherwise is shown to be such a
near tie: its margin is at most the two packages' difference in the
probabilities involved.  The executor faults the routed experts' pages
only, page for page as the JAX package does.
"""
import contextlib
import dataclasses
import filecmp
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import SMOKES  # noqa: E402
from repro_torch.core import pagestore, reap  # noqa: E402
from repro_torch.core.arena import GuestMemoryFile, InstanceArena  # noqa: E402
from repro_torch.core.executor import run_invocation  # noqa: E402
from repro_torch.core.snapshot import build_instance_snapshot  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.nn import spec  # noqa: E402
from repro_torch.serving import Orchestrator, ServeConfig  # noqa: E402

from test_torch_decode import BF16_ATOL, _f32_tree, run_jax, run_port, tokens_for  # noqa: E402

MOE = ["deepseek-moe-16b", "llama4-maverick-400b-a17b"]
TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=BF16_ATOL)}


@pytest.fixture(scope="module")
def jx():
    """The JAX package's MoE model, executor and serving (skips where JAX is
    absent)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import SMOKES as JAX_SMOKES
    from repro.core import pagestore as jax_pagestore
    from repro.core import reap as jax_reap
    from repro.core.arena import GuestMemoryFile as JaxGM
    from repro.core.arena import InstanceArena as JaxArena
    from repro.core.executor import run_invocation as jax_run_invocation
    from repro.core.snapshot import build_instance_snapshot as jax_build
    from repro.launch import steps as jax_steps
    from repro.models import moe as jax_moe
    from repro.nn import spec as jax_spec
    from repro.serving import Orchestrator as JaxOrchestrator
    from repro.serving import ServeConfig as JaxServeConfig
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, smokes=JAX_SMOKES, steps=jax_steps, spec=jax_spec,
        moe=jax_moe, build=jax_build, GM=JaxGM, Arena=JaxArena,
        run_invocation=jax_run_invocation, pagestore=jax_pagestore, reap=jax_reap,
        Orchestrator=JaxOrchestrator, ServeConfig=JaxServeConfig)


@contextlib.contextmanager
def jax_routes(jax):
    """Records each top-k the JAX package takes (the MoE layers' routing,
    in call order) as ``(probabilities, expert ids)`` numpy arrays, also
    from inside jitted scans (an ordered debug callback); read them after
    ``jax.effects_barrier()``."""
    seen, top_k = [], jax.lax.top_k

    def recording(x, k):
        vals, idx = top_k(x, k)
        jax.debug.callback(lambda p, i: seen.append((np.asarray(p, np.float32),
                                                     np.asarray(i))),
                           x, idx, ordered=True)
        return vals, idx
    jax.lax.top_k = recording
    try:
        yield seen
    finally:
        jax.lax.top_k = top_k


@contextlib.contextmanager
def port_routes(replay=None):
    """Records each ``moe.route`` call of the port as ``(probabilities,
    expert ids)`` numpy arrays; with ``replay`` (``jax_routes``' list) the
    port routes by the JAX package's decisions, call for call."""
    seen, route, calls = [], moe.route, iter(replay or ())

    def recording(p, x, cfg):
        probs = moe.router_probs(p, x)
        _, idx = moe.top_k(probs, cfg.top_k)
        seen.append((probs.reshape(-1, probs.shape[-1]).numpy(),
                     idx.reshape(-1, idx.shape[-1]).numpy()))
        if replay is not None:
            idx = torch.from_numpy(np.array(next(calls)[1])).long().reshape(idx.shape)
        return moe.gates_at(probs, idx), idx
    moe.route = recording
    try:
        yield seen
    finally:
        moe.route = route


def swapped_decisions(mine, theirs):
    """Per token whose expert set differs between two runs' routing: the
    largest gap, in this run's probabilities, between an expert it picks
    that the other does not and one the other picks that it does not, and
    the bound on that gap (the two runs' probabilities of those experts
    differ by the sum of their moves at most: the pair's order flipped)."""
    out = []
    for (p, idx), (q, ref) in zip(mine, theirs):
        for t in range(idx.shape[0]):
            a = sorted(set(idx[t].tolist()) - set(ref[t].tolist()))
            b = sorted(set(ref[t].tolist()) - set(idx[t].tolist()))
            if a:
                moved = np.abs(p[t].astype(np.float64) - q[t])
                out.append((float(p[t, a].max()) - float(p[t, b].min()),
                            float(moved[a].max() + moved[b].max())))
    return out


def jax_params(jx, jcfg, seed, dtype):
    host = jx.spec.host_initialize(jx.steps.param_specs(jcfg), seed=seed)
    cast = jx.jnp.float32 if dtype == "float32" else None
    return jx.spec.map_leaves(lambda p, s: jx.jnp.asarray(host[p]).astype(cast or s.dtype),
                              jx.steps.param_specs(jcfg))


def hold_routes(dtype, mine, theirs):
    """float32: the port routes every token as the JAX package does.
    bfloat16 (the port replayed the JAX routes): every decision the port
    would take otherwise is a near tie."""
    assert len(mine) == len(theirs) > 0
    if dtype == "float32":
        for (_, idx), (_, ref) in zip(mine, theirs):
            np.testing.assert_array_equal(idx, ref)
    for margin, bound in swapped_decisions(mine, theirs):
        assert 0 <= margin <= bound + 1e-9, (margin, bound)


# -- the model against the JAX package -----------------------------------------


@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_forward_matches_jax(jx, name, dtype):
    cfg, jcfg = SMOKES[name], jx.smokes[name]
    batch = steps.make_batch(cfg, 24, 2, "train", 5)
    with jax_routes(jx.jax) as theirs:
        want = np.asarray(jx.jax.jit(jx.steps.build_forward(jcfg))(
            jax_params(jx, jcfg, 3, dtype), {"tokens": jx.jnp.asarray(batch["tokens"])}),
            np.float32)
        jx.jax.effects_barrier()
    params = steps.init_params(cfg, 3, "cpu")
    if dtype == "float32":
        params = _f32_tree(params)
    with port_routes(None if dtype == "float32" else theirs) as mine:
        got = steps.build_forward(cfg)(params, batch)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])
    hold_routes(dtype, mine, theirs)


@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_prefill_decode_match_jax(jx, name, dtype):
    """Prefill, then decode steps: the first dense layers', the groups'
    dense layers' and the MoE layers' KV caches written in place."""
    tokens = tokens_for(name)
    with jax_routes(jx.jax) as theirs:
        want, _ = run_jax(jx, jx.smokes[name], 0, tokens, dtype)
        jx.jax.effects_barrier()
    with port_routes(None if dtype == "float32" else theirs) as mine:
        got, cache = run_port(SMOKES[name], 0, tokens, dtype)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, err_msg=f"step {i}", **TOL[dtype])
    hold_routes(dtype, mine, theirs)
    assert set(cache) == set(steps.cache_specs(SMOKES[name], 2, 8))


def test_apply_moe_mlp_drops_like_jax(jx):
    """A capacity small enough to drop assignments: the same ones kept (the
    cumulative-sum ranks, token-major), and the same outputs."""
    jnp = jx.jnp
    cfg = dataclasses.replace(SMOKES["deepseek-moe-16b"], capacity_factor=0.3)
    jcfg = dataclasses.replace(jx.smokes["deepseek-moe-16b"], capacity_factor=0.3)
    host = jx.spec.host_initialize(jx.steps.param_specs(jcfg), seed=1)
    pre = "groups/moe_layer/moe/"
    jp = {}
    for path, arr in host.items():
        if path.startswith(pre):
            *parents, leaf = path[len(pre):].split("/")
            node = jp
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = jnp.asarray(arr[0]).astype(jnp.float32)
    x = np.random.default_rng(2).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    want = np.asarray(jx.moe.apply_moe_mlp(jp, jnp.asarray(x), jcfg))
    p = jx.jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    got = moe.apply_moe_mlp(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)

    T, E, k = 48, cfg.n_experts, cfg.top_k
    C = moe.capacity(cfg, T)
    _, idx = moe.route(p, torch.from_numpy(x), cfg)
    keep = (moe.slot_ranks(idx.reshape(-1), E) < C).numpy()
    probs = jx.jax.nn.softmax(jnp.asarray(x.reshape(T, -1)) @ jp["router"], axis=-1)
    jidx = jx.jax.lax.top_k(probs, k)[1].reshape(-1)
    assign = jx.jax.nn.one_hot(jidx, E, dtype=jnp.int32)
    jkeep = np.asarray(jnp.sum((jnp.cumsum(assign, 0) - assign) * assign, -1) < C)
    np.testing.assert_array_equal(keep, jkeep)
    assert 0 < keep.sum() < keep.size


def test_top_k_breaks_ties_to_the_lower_index(jx):
    """``lax.top_k`` puts the lower index first among equal values;
    ``torch.topk`` promises nothing there.  Exact ties: repeated values,
    and a zero router (every probability equal)."""
    scores = np.array([[0.1, 0.3, 0.3, 0.1, 0.2, 0.3, 0.2, 0.0],
                       [0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5],
                       [0.0, 0.2, 0.0, 0.2, 0.0, 0.2, 0.0, 0.1]], np.float32)
    for k in (1, 2, 3, 6):
        vals, idx = moe.top_k(torch.from_numpy(scores), k)
        jvals, jidx = jx.jax.lax.top_k(jx.jnp.asarray(scores), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    cfg = SMOKES["deepseek-moe-16b"]
    p = {"router": torch.zeros(cfg.d_model, cfg.n_experts)}
    x = torch.randn(2, 5, cfg.d_model)
    gate, idx = moe.route(p, x, cfg)
    assert (idx == torch.arange(cfg.top_k)).all()
    assert torch.equal(gate, torch.full_like(gate, 1 / cfg.top_k))
    assert (moe.routed_experts(p, x, cfg) == torch.arange(cfg.top_k)).all()


@pytest.mark.parametrize("name", MOE)
def test_moe_cache_specs_match_jax(jx, name):
    mine = {p: (s.shape, s.dtype)
            for p, s in spec.tree_paths(steps.cache_specs(SMOKES[name], 3, 40))}
    theirs = {p: (s.shape, str(np.dtype(s.dtype)))
              for p, s in jx.spec.tree_paths(jx.steps.cache_specs(jx.smokes[name], 3, 40))}
    assert mine == theirs


def test_init_params_streams_host_initialize_bytes():
    """Slices that split a stacked leaf mid-row, and mid-uint32 of NumPy's
    float32 stream, still give ``host_initialize``'s bytes."""
    specs = steps.param_specs(SMOKES["deepseek-moe-16b"])
    host = spec.host_initialize(specs, seed=7)
    tree = spec.stream_initialize(specs, 7, "cpu", slice_elems=1001)
    paths = [p for p, _ in spec.tree_paths(specs)]
    assert "groups/moe_layer/moe/wi_gate" in paths
    for path in paths:
        t = tree
        for part in path.split("/"):
            t = t[part]
        got = (t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16
               else t.numpy())
        assert got.tobytes() == host[path].tobytes(), path


# -- snapshot, executor and serving ---------------------------------------------


@pytest.mark.parametrize("name", MOE)
def test_moe_invocation_faults_the_routed_experts_like_jax(jx, tmp_path, name):
    """Snapshots byte for byte; then one invocation in each package on a
    fresh arena: the same fault trace, page for page, so the same routed
    experts' pages and nothing of the others'."""
    cfg, jcfg = SMOKES[name], jx.smokes[name]
    gm_t = build_instance_snapshot(cfg, str(tmp_path / "t"), seed=3)
    gm_j = jx.build(jcfg, str(tmp_path / "j"), seed=3)
    assert filecmp.cmp(gm_t.mem_path, gm_j.mem_path, shallow=False)
    assert filecmp.cmp(gm_t.manifest_path, gm_j.manifest_path, shallow=False)
    batch = steps.make_batch(cfg, 3, 1, "train", 11)
    arena_t = InstanceArena(GuestMemoryFile.open(str(tmp_path / "t")))
    arena_j = jx.Arena(jx.GM.open(str(tmp_path / "j")))
    try:
        logits, _ = run_invocation(cfg, arena_t, batch, device="cpu")
        jlogits, _ = jx.run_invocation(jcfg, arena_j, batch)
        assert list(arena_t.stats.trace) == list(arena_j.stats.trace)
        experts = set()
        for path, e in gm_t.layout.entries.items():
            if "/moe/wi" in path or "/moe/wo" in path:
                experts |= set(e.pages())
        used = set(arena_t.stats.trace) & experts
        assert 0 < len(used) < len(experts)
        np.testing.assert_allclose(logits.float().numpy(), np.asarray(jlogits, np.float32),
                                   atol=BF16_ATOL)
    finally:
        arena_t.close()
        arena_j.close()


def test_moe_cold_invocation_equals_warm_forward(tmp_path):
    """The untied head reads no unfaulted page, so a cold invocation (the
    routed experts faulted, the others zero) computes a warm forward's
    logits, bit for bit."""
    cfg = SMOKES["deepseek-moe-16b"]
    build_instance_snapshot(cfg, str(tmp_path / "fn"), seed=4)
    batch = steps.make_batch(cfg, 16, 1, "train", 1)
    arena = InstanceArena(GuestMemoryFile.open(str(tmp_path / "fn")))
    try:
        cold, _ = run_invocation(cfg, arena, batch, device="cpu")
    finally:
        arena.close()
    warm = steps.build_forward(cfg)(steps.init_params(cfg, 4, "cpu"), batch)
    assert torch.equal(cold, warm)


def test_moe_reap_cold_start_matches_jax(jx, tmp_path):
    """Record, scale to zero and a REAP cold start of deepseek-moe-16b SMOKE
    in each package: the same trace, WS files and page store."""
    name = "deepseek-moe-16b"
    batch = steps.make_batch(SMOKES[name], 16, 1, "train", 6)
    try:
        for pkg, orch in (("jax", jx.Orchestrator(str(tmp_path / "jax"), jx.ServeConfig())),
                          ("torch", Orchestrator(str(tmp_path / "torch"),
                                                 ServeConfig(device="cpu")))):
            try:
                orch.register("fn", (jx.smokes if pkg == "jax" else SMOKES)[name],
                              warmup_batch=batch)
                _, rep = orch.invoke("fn", batch)
                assert rep.n_prefetched_pages == 0
                orch.scale_to_zero("fn")
                _, rep = orch.invoke("fn", batch)
                assert rep.n_prefetched_pages > 0 and rep.n_faults == 0
            finally:
                orch.close()
        for rel in ("fn.trace.npy", "fn.ws", "fn.mem", ".pagestore/index.json",
                    ".pagestore/chunks.data"):
            assert filecmp.cmp(tmp_path / "jax" / rel, tmp_path / "torch" / rel,
                               shallow=False), rel
    finally:
        for mod in (jx.pagestore, pagestore):
            mod.reset_stores()
        jx.reap.WS_CACHE.clear()
        reap.WS_CACHE.clear()


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "pixtral-12b", "seamless-m4t-medium"])
def test_serve_cli_runs_the_new_families_on_cpu(tmp_path, capsys, name):
    """``launch.serve`` end to end: record, REAP cold start, warm (the
    VLM's and the encoder-decoder's requests carry their modality)."""
    from repro_torch.launch import serve
    try:
        serve.main(["--arch", name, "--device", "cpu", "--seq", "24",
                    "--store", str(tmp_path / "store")])
    finally:
        pagestore.reset_stores()
        reap.WS_CACHE.clear()
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[1] for ln in lines] == ["[cold]", "[cold]", "[warm]"]
    assert "faults=0" in lines[2]


def test_route_replay_of_chip_smoke_reproduces_its_run():
    """``chip_smoke.RouteLog`` (the card's routing replay), on the CPU in
    float32: recorded from a greedy run, replayed into the same tokens
    through the plain versions and into the teacher-forced forward, which
    then agree with the run; the replays' own top-k agrees with the
    recorded decisions, and the drops are the same in the run and its
    plain replay (same tokens, same capacity)."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "chip_smoke.py")
    loader = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(cs)
    cs.DEVICE = "cpu"
    cfg = SMOKES["deepseek-moe-16b"]
    params = _f32_tree(steps.init_params(cfg, 0, "cpu"))
    prompt = {k: torch.from_numpy(v)
              for k, v in steps.make_batch(cfg, 12, 2, "prefill", 0).items()}
    log = cs.RouteLog(cfg, 2, 12 + 3, "cpu")
    with log.active("record"):
        run = cs.generate(cfg, params, prompt, 3, float32=True)
    with log.active("replay", "plain"):
        plain = cs.generate(cfg, params, prompt, 3, plain=True, forced=run["fed"],
                            float32=True)
    torch.testing.assert_close(plain["logits"], run["logits"], atol=1e-4, rtol=0)
    stats = log.summary()
    assert stats["record"]["decisions"] == 2 * (12 + 3) * moe.n_groups(cfg)
    assert stats["plain"]["differing"] == 0
    assert stats["plain"]["dropped"] == stats["record"]["dropped"]
    tokens = torch.cat([prompt["tokens"], run["fed"].int()], 1)
    with log.active("replay", "forward"):
        steps.build_forward(cfg)(params, {"tokens": tokens})
    assert log.summary()["forward"]["decisions"] == 2 * 15 * moe.n_groups(cfg)


@pytest.mark.cuda
def test_cuda_moe_cold_invocation_equals_warm_forward(tmp_path):
    """On the card: the route-then-fault invocation launches B3 once a
    layer and computes a warm forward's logits, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    from repro_torch.kernels import LAUNCHES
    cfg = SMOKES["deepseek-moe-16b"]
    build_instance_snapshot(cfg, str(tmp_path / "fn"), seed=4)
    batch = steps.make_batch(cfg, 16, 1, "train", 1)
    arena = InstanceArena(GuestMemoryFile.open(str(tmp_path / "fn")))
    n0 = LAUNCHES["flash_attention"]
    try:
        cold, _ = run_invocation(cfg, arena, batch, device="cuda")
    finally:
        arena.close()
    assert LAUNCHES["flash_attention"] == n0 + cfg.n_layers
    warm = steps.build_forward(cfg)(steps.init_params(cfg, 4, "cuda"), batch)
    assert cold.is_cuda and torch.equal(cold, warm)
