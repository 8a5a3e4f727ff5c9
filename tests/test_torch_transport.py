"""The port's page transport against the JAX package's, on the CPU.

* The codec encodes every chunk to the same bytes.
* The wire protocol interoperates: a JAX ``PageServer`` serves a port
  ``PageClient`` and a port server serves a JAX client -- inline, raw and
  compressed, and over shared memory -- with the same chunks and the same
  bytes on the wire, and a fetch installs into the port's arena.
* The transport source resolves a miss from a live owner's socket, and
  falls back to the origin when the owner is dead, or alive but silent for
  longer than its bound.
* One two-node socket fleet (``device="cpu"`` children, spawned once for
  the module) serves logits byte-identical to the port's inproc fleet on
  the same store, moves a WS across the process boundary, and reroutes
  around a killed node.  Its tests are ``slow`` like the JAX package's
  process fleet tests; every wait on it is bounded.
"""
import os
import socket

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.transport as jax_transport  # noqa: E402
import repro.transport.codec as jax_codec  # noqa: E402
import repro_torch.transport as torch_transport  # noqa: E402
import repro_torch.transport.codec as torch_codec  # noqa: E402
from repro.core import pagestore as jax_pagestore  # noqa: E402
from repro_torch.core import pagestore  # noqa: E402
from repro_torch.core.arena import PAGE, ArenaLayout, GuestMemoryFile, InstanceArena  # noqa: E402
from repro_torch.core.reap import ReapConfig, trace_path, ws_path  # noqa: E402
from repro_torch.transport import shm as torch_shm  # noqa: E402
from repro_torch.transport.wire import HEADER, MAGIC, T_MANIFEST, recv_frame  # noqa: E402

WAIT_S = 120.0


def low_entropy_page(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    return np.repeat(rng.integers(0, 4, size=64, dtype=np.uint8), PAGE // 64).tobytes()


def random_page(seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, PAGE, dtype=np.uint8).tobytes()


def bf16_page(seed: int) -> bytes:
    """A page of bf16 weights, as a snapshot holds them (high byte repeats)."""
    w = np.random.default_rng(seed).standard_normal(PAGE // 2).astype(np.float32) * 0.02
    return (w.view(np.uint32) >> 16).astype(np.uint16).tobytes()


PAGES = {"low_entropy": low_entropy_page(1), "random": random_page(2),
         "zeros": bytes(PAGE), "bf16_weights": bf16_page(3),
         "half_zero": bytes(PAGE // 2) + random_page(4)[:PAGE // 2]}


# -- codec --------------------------------------------------------------------

@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("kind", sorted(PAGES))
def test_codec_bytes_match_jax(kind, compress):
    block = PAGES[kind]
    assert torch_codec.probe_entropy(block) == jax_codec.probe_entropy(block)
    enc, payload = torch_codec.encode_chunk(block, compress=compress)
    assert (enc, payload) == jax_codec.encode_chunk(block, compress=compress)
    assert torch_codec.decode_chunk(enc, payload) == block
    if compress and kind in ("low_entropy", "zeros"):
        assert enc == "zlib" and len(payload) < PAGE


def test_codec_stats_match_jax():
    def run(codec):
        stats = codec.CodecStats()
        for block in PAGES.values():
            enc, payload = codec.encode_chunk(block)
            stats.record(enc, len(block), len(payload))
        return stats.as_dict(), stats.ratio()
    assert run(torch_codec) == run(jax_codec)


# -- the wire, across the packages ---------------------------------------------

def make_records(n_rec: int = 2, n_pages: int = 8, page=low_entropy_page) -> dict:
    records = {}
    for i in range(n_rec):
        data = b"".join(page(100 * i + j) for j in range(n_pages))
        hashes = [pagestore.chunk_hash(data[j * PAGE:(j + 1) * PAGE])
                  for j in range(n_pages)]
        records[f"rec_{i}"] = (list(range(n_pages)), data, hashes)
    return records


PKGS = {"jax": jax_transport, "torch": torch_transport}
WIRE_MODES = {            # PageServer knobs
    "inline_raw": dict(use_shm=False),
    "inline_zlib": dict(use_shm=False, compress=True),
    "shm": dict(use_shm=True, inline_max_bytes=1),
}


def _exchange(server_pkg, client_pkg, mode, records, tmp_path, have=()):
    path = str(tmp_path / "p.sock")          # AF_UNIX paths are short
    server = PKGS[server_pkg].PageServer(path, records.get, **WIRE_MODES[mode])
    client = PKGS[client_pkg].PageClient(path)
    try:
        out = []
        for base in sorted(records):
            res = client.fetch(base, have)
            out.append((list(res.pages), res.hashes, res.transport, res.chunks,
                        res.wire_bytes, res.shm_bytes))
        assert client.fetch("no_such_record") is None
        cstats = client.stats.as_dict()
        cstats.pop("fetch_rtt_s")
    finally:
        client.close()
        server.close()       # joins its handler threads: their counts are final
    return out, cstats, server.stats.as_dict(), server.codec.as_dict()


@pytest.mark.parametrize("mode", sorted(WIRE_MODES))
@pytest.mark.parametrize("server,client", [("jax", "torch"), ("torch", "jax")])
def test_wire_interoperates_with_jax(server, client, mode, tmp_path):
    if mode == "shm" and not torch_shm.shm_available():
        pytest.skip("multiprocessing.shared_memory unavailable on this host")
    records = make_records(n_pages=24, page=bf16_page)
    got = _exchange(server, client, mode, records, tmp_path)
    same = _exchange("jax", "jax", mode, records, tmp_path)
    assert got == same                       # chunks, transports and wire bytes
    for (pages, hashes, transport, chunks, *_), base in zip(got[0], sorted(records)):
        assert b"".join(chunks[h] for h in hashes) == records[base][1]
        assert transport == ("shm" if mode == "shm" else "inline")


@pytest.mark.parametrize("server,client", [("jax", "torch"), ("torch", "jax")])
def test_wire_dedup_negotiation_matches_jax(server, client, tmp_path):
    records = make_records(n_rec=1, n_pages=16)
    have = set(records["rec_0"][2][::2])
    got = _exchange(server, client, "inline_zlib", records, tmp_path, have)
    assert got == _exchange("jax", "jax", "inline_zlib", records, tmp_path, have)
    assert set(got[0][0][3]) == set(records["rec_0"][2]) - have


def test_recv_frame_rejects_garbage_and_truncation():
    a, b = socket.socketpair()
    try:
        a.sendall(HEADER.pack(b"XXXX", T_MANIFEST, 0))
        with pytest.raises(torch_transport.BadMagicError):
            recv_frame(b)
        a.sendall(HEADER.pack(MAGIC, T_MANIFEST, 100) + b"x" * 10)
        a.close()
        with pytest.raises(torch_transport.TruncatedFrameError):
            recv_frame(b)
    finally:
        b.close()


def _arena(tmp_path, n_pages: int) -> InstanceArena:
    layout = ArenaLayout.build([("params/w", (n_pages * PAGE,), "uint8", "serve")])
    gm = GuestMemoryFile.create(str(tmp_path / "gm"), layout,
                                {"params/w": np.zeros(n_pages * PAGE, np.uint8)})
    return InstanceArena(gm)


@pytest.mark.parametrize("server", ["jax", "torch"])
def test_shm_fetch_installs_into_the_port_arena(server, tmp_path):
    """The shm data plane end to end: the segment round-trips, its chunks
    are verified from the mapping, and ``fetch_install`` scatters them
    into the port's arena; the responder unlinks the segment."""
    if not torch_shm.shm_available():
        pytest.skip("multiprocessing.shared_memory unavailable on this host")
    seg = torch_shm.ShmSegment(3 * PAGE)
    try:
        offs = [seg.write_chunk(PAGES[k]) for k in ("random", "zeros", "bf16_weights")]
        view = torch_shm.ShmView(seg.name)
        assert bytes(view.chunk(offs[2], PAGE)) == PAGES["bf16_weights"]
        block = view.block(0, 3)
        assert block.tobytes() == PAGES["random"] + PAGES["zeros"] + PAGES["bf16_weights"]
        del block
        view.close()
    finally:
        seg.release()
    with pytest.raises(FileNotFoundError):
        torch_shm.ShmView(seg.name)
    records = make_records(n_rec=1, n_pages=32, page=random_page)
    pages, data, _ = records["rec_0"]
    records["rec_0"] = (pages[::-1], data, records["rec_0"][2])  # pages out of order
    path = str(tmp_path / "p.sock")
    srv = PKGS[server].PageServer(path, records.get, use_shm=True, inline_max_bytes=1)
    cli = torch_transport.PageClient(path)
    arena = _arena(tmp_path, 32)
    try:
        res = cli.fetch_install("rec_0", arena)
        assert res.transport == "shm" and res.shm_bytes == len(data)
        got = np.frombuffer(arena.buf, np.uint8, count=32 * PAGE).reshape(32, PAGE)
        want = np.frombuffer(data, np.uint8).reshape(32, PAGE)[::-1]
        np.testing.assert_array_equal(got, want)
        assert arena.resident.all()
    finally:
        arena.close()
        cli.close()
        srv.close()
    assert srv.stats.as_dict()["shm_responses"] == 1


# -- the transport source ------------------------------------------------------

def _source_setup(tmp_path):
    """A node-a's view of a record that node-b owns: (spec, ring, base,
    cfg, pages, data), the WS written to the origin."""
    from repro_torch.cluster.shardmap import ConsistentHashRing
    from repro_torch.core.reap import _read_ws
    from repro_torch.transport.procnode import NodeSpec
    sock_dir = str(tmp_path / "socks")
    os.makedirs(sock_dir)
    node_ids = ("node-a", "node-b")
    spec = NodeSpec(node_id="node-a", store_dir=str(tmp_path), sock_dir=sock_dir,
                    node_ids=node_ids, config=None)
    ring = ConsistentHashRing(list(node_ids), vnodes=spec.vnodes)
    name = next(f"srec_{i}" for i in range(1000) if ring.owner(f"srec_{i}") == "node-b")
    base = str(tmp_path / name)
    np.save(trace_path(base), np.arange(4, dtype=np.int64))
    with open(ws_path(base), "wb") as f:
        f.write(b"".join(random_page(i) for i in range(4)))
    cfg = ReapConfig(o_direct=False)
    p, d = _read_ws(base, cfg)
    return spec, ring, base, cfg, p, d


def test_source_live_owner_then_dead_owner(tmp_path):
    from repro_torch.transport.procnode import TransportSource
    spec, ring, base, cfg, p, d = _source_setup(tmp_path)
    hashes = [pagestore.chunk_hash(d[j * PAGE:(j + 1) * PAGE]) for j in range(len(p))]
    # the owner runs the JAX package's server: the port dials it
    server = jax_transport.PageServer(spec.sock_path("node-b"), {base: (p, d, hashes)}.get,
                                      use_shm=False)
    source = TransportSource(spec, ring)
    try:
        assert source(base, cfg) == ([int(x) for x in p], d)
        st = source.stats()
        assert st["wire_rx_bytes"] > 0 and st["fetch_rtt_s"]["count"] == 1
        assert st["fetch_wait_s"]["count"] == 1
        assert st["fetch_wait_s"]["sum"] <= st["fetch_rtt_s"]["sum"]
        server.close()                       # the owner dies
        assert source(base, cfg)[1] == d     # the origin serves, nothing raises
        st = source.stats()
        assert (st["remote_fetches"], st["dead_owner_fallbacks"], st["origin_reads"]) == (1, 1, 1)
    finally:
        source.close()
        server.close()


def test_source_falls_back_from_a_silent_owner_within_its_bound(tmp_path):
    """An owner that is alive but never answers (it accepts and reads the
    request, then stalls) holds a fetch for one socket timeout, no longer:
    the source then drops it as dead and the origin serves.  The bound is
    the page client's, ``FETCH_TIMEOUT_S`` unless the source is given one."""
    import threading
    import time
    from repro_torch.transport.procnode import TransportSource
    from repro_torch.transport.wire import FETCH_TIMEOUT_S
    spec, ring, base, cfg, p, d = _source_setup(tmp_path)
    assert TransportSource(spec, ring).timeout_s == FETCH_TIMEOUT_S
    listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    listener.bind(spec.sock_path("node-b"))
    listener.listen(1)
    stop = threading.Event()
    held = []

    def stall():
        conn, _ = listener.accept()
        held.append(conn)
        conn.recv(1 << 16)                   # the FETCH arrives: no reply
        stop.wait(WAIT_S)

    t = threading.Thread(target=stall, daemon=True)
    t.start()
    bound = 1.0
    source = TransportSource(spec, ring, timeout_s=bound)
    try:
        t0 = time.monotonic()
        assert source(base, cfg) == ([int(x) for x in p], d)
        took = time.monotonic() - t0
        assert bound <= took < bound + 5.0, took
        st = source.stats()
        assert (st["remote_fetches"], st["dead_owner_fallbacks"], st["origin_reads"]) == (0, 1, 1)
    finally:
        stop.set()
        source.close()
        t.join(WAIT_S)
        for c in held:
            c.close()
        listener.close()


def test_child_checks_its_own_device(tmp_path):
    """An unpickled ServeConfig skips its __post_init__: the child's entry
    point rebuilds it, so a device the child cannot use raises there
    instead of the node serving elsewhere."""
    from repro_torch.serving import ServeConfig
    from repro_torch.transport.procnode import NodeSpec, _node_main
    config = ServeConfig(device="cpu")
    object.__setattr__(config, "device", "cuda:99")   # as unpickled: unchecked
    spec = NodeSpec(node_id="node-0", store_dir=str(tmp_path), sock_dir=str(tmp_path),
                    node_ids=("node-0",), config=config)
    with pytest.raises(RuntimeError, match="CUDA"):
        _node_main(spec, conn=None)
    assert not (tmp_path / "node-0.sock").exists()      # no server was started


# -- one socket fleet of CPU children --------------------------------------------

def _serve_config(transport: str):
    from repro_torch.serving import RouterConfig, ServeConfig
    return ServeConfig(
        overlap_install=False, device="cpu", keepalive_s=30.0, warm_limit=2,
        router=RouterConfig(max_concurrency=1, max_instances_per_function=2,
                            queue_depth=16, batch_restore_limit=1),
        transport=transport, transport_compress=True)


@pytest.fixture(scope="module")
def socket_fleet(tmp_path_factory):
    from repro_torch.cluster import ScheduleConfig, build_fleet
    from repro_torch.configs import SMOKES
    store = str(tmp_path_factory.mktemp("sock_store"))
    cfg = SMOKES["olmo-1b"]
    batch = {"tokens": np.random.default_rng(1).integers(0, cfg.vocab, (2, 16),
                                                         dtype=np.int32)}
    fleet = build_fleet(2, store, config=_serve_config("socket"),
                        cfg=ScheduleConfig(placement="locality", seed=7))
    try:
        fleet.register("pfn", cfg, seed=0, warmup_batch=batch)
        _, rep = fleet.submit("pfn", batch).result(WAIT_S)       # record
        assert rep.n_prefetched_pages == 0
        yield fleet, store, cfg, batch
    finally:
        fleet.close()
    pagestore.reset_stores()
    jax_pagestore.reset_stores()


@pytest.mark.slow
def test_socket_fleet_logits_match_inproc_fleet(socket_fleet):
    """Logits served across the process boundary are byte-identical to the
    port's inproc fleet on the same store (both cold)."""
    from repro_torch.cluster import ScheduleConfig, build_fleet
    fleet, store, cfg, batch = socket_fleet
    out_sock, rep = fleet.submit("pfn", batch, force_cold=True).result(WAIT_S)
    assert rep.load_vmm_s > 0 and rep.n_prefetched_pages > 0
    inproc = build_fleet(2, store, config=_serve_config("inproc"),
                         cfg=ScheduleConfig(placement="locality", seed=7))
    try:
        inproc.register("pfn", cfg, seed=0, warmup_batch=batch)
        out_in, rep = inproc.submit("pfn", batch, force_cold=True).result(WAIT_S)
        assert rep.load_vmm_s > 0
    finally:
        inproc.close()
    assert out_sock.dtype == out_in.dtype == torch.bfloat16
    assert out_sock.shape == out_in.shape
    assert (out_sock.view(torch.int16).numpy().tobytes()
            == out_in.view(torch.int16).numpy().tobytes())


@pytest.mark.slow
def test_socket_fleet_cold_burst_crosses_the_process_boundary(socket_fleet):
    fleet, _store, _cfg, batch = socket_fleet
    fleet.scale_to_zero("pfn")
    fleet.clear_caches()
    assert fleet.rebalance() == {"pfn": 1}
    fleet.reset_stats()
    invs = [fleet.submit("pfn", batch) for _ in range(2)]
    outs = [inv.result(WAIT_S) for inv in invs]
    assert sorted(inv.node_ids[-1] for inv in invs) == ["node-0", "node-1"]
    assert all(rep.n_prefetched_pages > 0 for _, rep in outs)
    assert torch.equal(outs[0][0], outs[1][0])
    st = fleet.stats()
    owner = fleet.ring.owner("pfn")
    other = next(n for n in st["nodes"] if n != owner)
    tr = st["nodes"][other]["transport"]
    assert tr["remote_fetches"] == 1 and tr["wire_rx_bytes"] > 0
    assert st["nodes"][owner]["transport"]["chunks_served"] > 0
    for ns in st["nodes"].values():
        assert set(ns["kernel_launches"]) >= {"flash_attention", "gather_pages"}
        assert set(ns["transport"]["fetch_rtt_s"]) == {"count", "sum", "p50", "p95"}


@pytest.mark.slow
def test_socket_fleet_warm_serves_without_restore(socket_fleet):
    fleet, _store, _cfg, batch = socket_fleet
    fleet.submit("pfn", batch).result(WAIT_S)
    _, rep = fleet.submit("pfn", batch).result(WAIT_S)
    assert rep.load_vmm_s == 0.0


@pytest.mark.slow
def test_socket_fleet_kill_reroutes_to_survivor(socket_fleet):
    """Runs last in this module: it kills a child.  Pending work resolves on
    the survivor, and nothing hangs."""
    fleet, _store, _cfg, batch = socket_fleet
    invs = [fleet.submit("pfn", batch, force_cold=True) for _ in range(4)]
    victim = max(fleet.stats()["placements"].items(), key=lambda kv: kv[1])[0]
    proc = fleet.nodes[victim]._proc
    fleet.kill_node(victim)
    outs = [inv.result(WAIT_S) for inv in invs]
    assert len(outs) == 4 and all(o.numel() > 0 for o, _ in outs)
    assert not proc.is_alive() and not fleet.nodes[victim].alive
    for inv in invs:                          # moved work left the victim
        assert len(inv.node_ids) == 1 or inv.node_ids[-1] != victim
    _, rep = fleet.submit("pfn", batch).result(WAIT_S)
    assert rep.processing_s > 0
